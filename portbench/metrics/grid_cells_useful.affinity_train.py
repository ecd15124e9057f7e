"""Share of the grid the head's kernels launch over (images x phrase slots
x box slots) whose cells carry a loss: the program's counters
``batch.grid_cells_real`` over ``batch.grid_cells`` (``AffinityBatcher``;
the rest is bucket padding and the padding images of short batches), %."""

from portbench.lib import spans


def read(run: dict):
    return spans.share(run, "batch.grid_cells_real", "batch.grid_cells")
