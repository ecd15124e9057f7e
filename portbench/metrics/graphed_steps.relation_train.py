"""Share of the train steps that replayed a CUDA graph: the program's
counters ``train.graph.replay`` over ``train.step``, %."""

from portbench.lib import spans


def read(run: dict):
    return spans.share(run, "train.graph.replay", "train.step")
