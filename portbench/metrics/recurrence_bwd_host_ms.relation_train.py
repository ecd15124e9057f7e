"""Host time of the LSTM recurrence's backward, the Python loop of eager
launches (the program's span ``icl.lstm.backward`` in
``ops/lstm_recurrence.py``, on autograd's thread), ms a step
(``icl.train.step``)."""

from portbench.lib import spans


def read(run: dict):
    return spans.ms_per(run, "icl.lstm.backward", "icl.train.step")
