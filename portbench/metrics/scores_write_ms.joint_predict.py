"""The ``.scores`` and ``.affinity.rank`` writes of a pass: the program's
spans ``icl.scores.write`` (``_predict.write_scores``,
``affinity.write_rank``) in the traced window, ms a pass."""

from portbench.lib.sweeps import write_ms_per_pass


def read(run: dict):
    return write_ms_per_pass(run)
