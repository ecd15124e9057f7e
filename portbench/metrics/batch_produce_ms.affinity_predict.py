"""Time the prefetch worker took to produce a batch (the program's span
``icl.prefetch.produce`` around its ``next()`` on the batcher), ms a
batch."""

from portbench.lib import spans


def read(run: dict):
    return spans.ms_per(run, "icl.prefetch.produce")
