"""Evaluation helpers (the port's copy of ``icl/eval``)."""

from icl_torch.eval.scoredict import ScoreDict

__all__ = ["ScoreDict"]
