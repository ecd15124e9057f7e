"""Joint inference's useful float work in the traced window (each batch of
the four sweeps, ``work/joint-flickr30k.predict.py``) over the window times
the card's float32 peak outside the tensor cores (67 TFLOP/s, the ``high``
precision's f32 products), %."""

from portbench.lib import cell, peaks
from portbench.lib.readers import mfu


def read(run: dict):
    return mfu(run, cell.work(run["cell"]).flops, peaks.F32)
