"""The affinity predict's useful float work in the traced window (valid
tokens, phrases, boxes and cells, ``work/affinity-flickr30k.predict.py``)
over the window times the card's float32 peak outside the tensor cores (67 TFLOP/s,
the ``high`` precision's f32 products), %."""

from portbench.lib import cell, peaks
from portbench.lib.readers import mfu


def read(run: dict):
    return mfu(run, cell.work(run["cell"]).flops, peaks.F32)
