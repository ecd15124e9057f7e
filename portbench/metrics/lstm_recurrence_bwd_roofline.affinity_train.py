"""The phrase LSTM's backward kernel (``csrc/lstm_recurrence_bwd.cu``,
``lstm_bwd_cluster_kernel``; R's transpose and the dR GEMM beside it are
launches of their own and not counted) in the affinity train step: the
least time the card could take for the traced window's calls
(``work/affinity-flickr30k-train.train.py: lstm_bwd_bound_s``) over the device
time of its launches, %."""

from portbench.lib import cell
from portbench.lib.readers import roofline

KERNELS = r"lstm_bwd_cluster_kernel"


def read(run: dict):
    t = run.get("trace")
    if t is None:
        return None
    return roofline(run, t.kernels(KERNELS),
                    cell.work(run["cell"]).lstm_bwd_bound_s)
