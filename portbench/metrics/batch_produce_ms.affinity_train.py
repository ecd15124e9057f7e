"""Time the prefetch worker took to produce a train batch (the program's
span ``icl.prefetch.produce`` around its ``next()`` on the feed: the
batcher's padding and the ``to_device`` copy inside it), ms a batch."""

from portbench.lib import spans


def read(run: dict):
    return spans.ms_per(run, "icl.prefetch.produce")
