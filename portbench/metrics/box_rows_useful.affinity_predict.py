"""Share of the box block's staged rows that hold a real box: the
program's counters ``batch.box_rows_real`` over ``batch.box_rows``
(``AffinityBatcher``; the rest is bucket padding and the padding images of
half-empty batches), %."""

from portbench.lib import spans


def read(run: dict):
    return spans.share(run, "batch.box_rows_real", "batch.box_rows")
