"""The fused-loss backward of the training grid head (K8,
``csrc/grid_head_train.cu``: its logit-gradient pass ``head_fwd*_kernel``
in mode 2, then ``head_bwd_kernel`` and the ``sum_rows_kernel`` after it)
in the relation train step: the least time the card could take for the
traced window's calls (``work/relation-flickr30k.train.py:
ght_loss_bwd_bound_s``) over the device time of those launches, %."""

import re

from portbench.lib import cell
from portbench.lib.readers import roofline

FIRST_HALF = re.compile(r"head_fwd(_onepass)?_kernel<2\b")
SECOND_HALF = re.compile(r"head_bwd_kernel")
SUMS = re.compile(r"sum_rows_kernel")


def k8_launches(kernels: list) -> list:
    """K8's launches among the window's kernels, in time order: the
    mode-2 forward pass, the backward, and the row sums that follow the
    backward (the loss's forward, K7, runs its own row sums)."""
    out, after_bwd = [], False
    for k in kernels:
        if FIRST_HALF.search(k[0]) or SECOND_HALF.search(k[0]):
            out.append(k)
            after_bwd = bool(SECOND_HALF.search(k[0]))
        elif SUMS.search(k[0]) and after_bwd:
            out.append(k)
            after_bwd = False
        else:
            after_bwd = False
    return out


def read(run: dict):
    t = run.get("trace")
    if t is None:
        return None
    spec = run["cell"]["spec"]
    exact = spec["precision"] == "highest"
    bound = cell.work(run["cell"]).ght_loss_bwd_bound_s
    return roofline(run, k8_launches(t.kernels()),
                    lambda s, cfg: bound(s, cfg, spec["dropout"], exact))
