"""The grid head kernel (K1, ``csrc/grid_head.cu``) at relation's O = 4 in
joint inference: the least time the card could take for the traced
window's relation batches (``work/joint-flickr30k.predict.py:
grid_head_bound_s``) over the device time of the kernel's launches at
O = 4 (``grid_head_kernel<4, ...>``; affinity's launches are at O = 2), %."""

from portbench.lib import cell
from portbench.lib.readers import roofline

KERNELS = r"\bgrid_head_kernel<4\b"


def read(run: dict):
    t = run.get("trace")
    if t is None:
        return None
    bound = cell.work(run["cell"]).grid_head_bound_s
    return roofline(run, t.kernels(KERNELS),
                    lambda s, cfg: bound(s, cfg) if s["task"] == "relation"
                    else 0.0)
