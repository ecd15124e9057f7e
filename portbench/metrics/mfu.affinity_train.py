"""The affinity train steps' useful float work in the traced window
(forward and backward, ``work/affinity-flickr30k-train.train.py``) over the
window times the card's peak for the cell's precision: float32 outside the
tensor cores (67 TFLOP/s) under ``highest``, TF32 (494.7 TFLOP/s) under
``default``, %."""

from portbench.lib import cell, peaks
from portbench.lib.readers import mfu


def read(run: dict):
    spec = run["cell"]["spec"]
    peak = peaks.F32 if spec["precision"] == "highest" else peaks.TF32
    flops = cell.work(run["cell"]).flops
    return mfu(run, lambda s, cfg: flops(s, cfg, spec["dropout"]), peak)
