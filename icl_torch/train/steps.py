"""Predict steps (counterpart of icl/train/steps.py; predict only)."""

from __future__ import annotations

import torch

from icl_torch.models.relation import RelationModel


def relation_predict(model: RelationModel, table: torch.Tensor,
                     batch: dict) -> torch.Tensor:
    """Relation class probabilities [I, P, 4] (softmax over the logits)."""
    with torch.inference_mode():
        return torch.softmax(model(table, batch), dim=-1)
