"""Host time of the affinity train step's ``loss.backward()`` (the
program's span ``icl.train.backward``), ms a step (``icl.train.step``)."""

from portbench.lib import spans


def read(run: dict):
    return spans.ms_per(run, "icl.train.backward", "icl.train.step")
