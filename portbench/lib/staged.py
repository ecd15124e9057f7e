"""The share of staged batches that went to the device in one copy from a
pinned slab (``icl_torch/data/staging.py``), as the ``slab_staged.*``
readers take it."""

from __future__ import annotations

from portbench.lib import spans


def slab_share(run: dict):
    """The program's counter ``h2d.slab`` (one a batch copied from one
    slab) over its spans ``icl.h2d`` (one a batch staged), %; None where
    the program keeps no such counter or staged nothing."""
    snap = spans.of(run)
    if snap is None:
        return None
    slab = snap["counters"].get("h2d.slab")
    staged = snap["spans"].get("icl.h2d")
    if slab is None or not staged or not staged["count"]:
        return None
    return slab / staged["count"] * 100.0
