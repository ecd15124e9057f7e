"""The program's predict-sweep spans (``icl_torch/cli/_predict.py``) as the
``joint.predict`` readers take them: ``icl.sweep``, one a sweep with its
``task`` among its attributes, and ``icl.scores.write``, one a written
file.  A program without them gives None, and the metric is left out of
the line."""

from __future__ import annotations

from portbench.lib import spans


def sweep_share(run: dict, tasks: tuple[str, ...]):
    """The share of the traced window inside ``icl.sweep`` spans of
    ``tasks``, %."""
    snap, t = spans.of(run), run.get("trace")
    if snap is None or t is None or t.window_s <= 0:
        return None
    ns = [e["end_ns"] - e["start_ns"] for e in snap["events"]
          if e["name"] == "icl.sweep" and e["attrs"].get("task") in tasks]
    if not ns:
        return None
    return sum(ns) * 1e-9 / t.window_s * 100.0


def write_ms_per_pass(run: dict):
    """The seconds of ``icl.scores.write`` in the traced window, in ms a
    pass of the window."""
    snap = spans.of(run)
    passes = run["stats"].get("passes")
    if snap is None or not passes:
        return None
    got = snap["spans"].get("icl.scores.write")
    if not got or not got["count"]:
        return None
    return got["seconds"] * 1e3 / passes
