"""Share of the traced window inside the two mention tasks' predict
sweeps: the program's spans ``icl.sweep`` of nonvisual and cardinality
(``icl_torch/cli/_predict.py: predict_in_order``), %."""

from portbench.lib.sweeps import sweep_share


def read(run: dict):
    return sweep_share(run, ("nonvisual", "cardinality"))
