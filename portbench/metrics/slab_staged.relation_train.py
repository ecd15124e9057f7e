"""Share of the batches that went to the device in one copy from a pinned
slab (``icl_torch/data/staging.py``): the program's counter ``h2d.slab``
over its spans ``icl.h2d``, one a train batch staged on the prefetch
worker, %."""

from portbench.lib.staged import slab_share


def read(run: dict):
    return slab_share(run)
