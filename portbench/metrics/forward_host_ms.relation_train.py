"""Host time of the train step's forward pass and loss (the program's
span ``icl.train.forward``), ms a step (``icl.train.step``)."""

from portbench.lib import spans


def read(run: dict):
    return spans.ms_per(run, "icl.train.forward", "icl.train.step")
