"""Host time of the train step's Adam update (the program's span
``icl.train.optimizer``), ms a step (``icl.train.step``)."""

from portbench.lib import spans


def read(run: dict):
    return spans.ms_per(run, "icl.train.optimizer", "icl.train.step")
