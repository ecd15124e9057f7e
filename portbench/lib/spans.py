"""The program's own spans and counters (``icl_torch.util.trace``) as the
per-layer readers take them.

Beside ``lib/program.py`` (and the drivers), this is the one place of the
benchmark that imports ``icl_torch``: the readers reach the program's
``snapshot()`` only through here.  The program keeps its spans only while
a ``torch.profiler`` session runs, so what a run's readers see is its
``--trace 1`` window.  The first reader of a run takes the snapshot and
empties the program's log; the others read the same snapshot from the run.
A program without the tracer gives None, and so does a span or counter that
recorded nothing: the metric is then left out of the line.
"""

from __future__ import annotations

KEY = "icl_spans"


def _take():
    try:
        from icl_torch.util import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    trace.reset()
    return snap


def of(run: dict):
    """The program's snapshot for this run (None without the tracer)."""
    if KEY not in run:
        run[KEY] = _take()
    return run[KEY]


def ms_per(run: dict, name: str, per: str | None = None):
    """The seconds of span ``name`` in the window, in ms a span ``per``
    (a span ``name`` itself by default)."""
    snap = of(run)
    if snap is None:
        return None
    got, by = snap["spans"].get(name), snap["spans"].get(per or name)
    if not got or not by or not by["count"]:
        return None
    return got["seconds"] * 1e3 / by["count"]


def share(run: dict, part: str, whole: str):
    """Counter ``part`` over counter ``whole``, %."""
    snap = of(run)
    if snap is None:
        return None
    num, den = snap["counters"].get(part), snap["counters"].get(whole)
    if num is None or not den:
        return None
    return num / den * 100.0
