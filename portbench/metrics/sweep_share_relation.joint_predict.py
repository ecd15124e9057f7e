"""Share of the traced window inside relation's predict sweeps: the
program's spans ``icl.sweep`` of that task (``icl_torch/cli/_predict.py:
predict_in_order``), %."""

from portbench.lib.sweeps import sweep_share


def read(run: dict):
    return sweep_share(run, ("relation",))
