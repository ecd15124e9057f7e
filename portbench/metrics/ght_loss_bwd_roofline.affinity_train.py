"""The fused-loss backward of the training grid head (K8) in the affinity
train step: the least time the card could take for the traced window's
calls (``work/affinity-flickr30k-train.train.py: ght_loss_bwd_bound_s``, over A
phrases by B boxes) over the device time of K8's launches, %.  Read as
``ght_loss_bwd_roofline`` reads it: its ``k8_launches`` and the cell's own
work file."""

from portbench.lib import cell

read = cell.metric_reader("ght_loss_bwd_roofline").read
