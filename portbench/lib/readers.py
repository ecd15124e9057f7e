"""What the per-layer metric files share: each file names its quantity,
these compute it from a traced run.  A reader that finds nothing to read
returns None, and the metric is left out of the line."""

from __future__ import annotations


def idle_share(run: dict):
    """Share of the traced window with no device operation running, %."""
    t = run.get("trace")
    if t is None or not t.ops:
        return None
    return t.idle_share()


def mfu(run: dict, flops_of, peak: float):
    """The useful float work of the traced window's inputs (``flops_of``
    of each batch's stats) over the window times ``peak``, %."""
    t, stats = run.get("trace"), run["stats"].get("stats")
    if t is None or not stats or not t.ops:
        return None
    cfg = run["stats"]["cfg"]
    work = sum(flops_of(s, cfg) for s in stats)
    return work / (t.window_s * peak) * 100.0


def roofline(run: dict, kernels: list, bound_of):
    """Sum over the traced window's calls of the least time the card could
    take (``bound_of`` of each batch's stats) over the device time of the
    launches in ``kernels``, %."""
    t, stats = run.get("trace"), run["stats"].get("stats")
    if t is None or not stats or not kernels:
        return None
    busy = sum(k[2] for k in kernels) * 1e-6
    if busy <= 0:
        return None
    cfg = run["stats"]["cfg"]
    return sum(bound_of(s, cfg) for s in stats) / busy * 100.0

