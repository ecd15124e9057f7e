"""The relation train steps' useful float work in the traced window
(forward and backward, ``work/relation-flickr30k.train.py``) over
the window times the card's peak for the cell's precision: float32 outside
the tensor cores (67 TFLOP/s) under ``highest``, TF32 (494.7 TFLOP/s)
under ``default``, %."""

from portbench.lib import cell, peaks
from portbench.lib.readers import mfu


def read(run: dict):
    peak = (peaks.F32 if run["cell"]["spec"]["precision"] == "highest"
            else peaks.TF32)
    return mfu(run, cell.work(run["cell"]).flops, peak)
