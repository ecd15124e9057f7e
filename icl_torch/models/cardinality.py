"""Box-cardinality predictor (counterpart of icl/models/cardinality.py).

Softmax over box-count bins {0, 1, ..., 10, 11+} per mention, a constraint
signal for the downstream ILP.  The body is the nonvisual FFNN over the
mean word vector with a 12-way head.
"""

from __future__ import annotations

import torch

from icl_torch.models.nonvisual import MentionFFNN

CARDINALITY_CLASSES = tuple(str(i) for i in range(11)) + ("11+",)


class CardinalityModel(MentionFFNN):
    """Dense(hidden, relu) -> Dropout -> Dense(12); logits out."""

    task = "cardinality"

    def __init__(self, emb_dim: int, hidden: int = 300, dropout: float = 0.5,
                 num_classes: int = len(CARDINALITY_CLASSES),
                 device: torch.device | None = None):
        super().__init__(emb_dim, hidden, dropout, num_classes, device)
