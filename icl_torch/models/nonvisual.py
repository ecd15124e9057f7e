"""Nonvisual-mention detector (counterpart of icl/models/nonvisual.py).

Binary visual/nonvisual classifier over a mention's mean word vector:
``mean_w2v(mention tokens) -> Dense(hidden, relu) -> Dropout -> Dense(2)``,
class order ``[visual, nonvisual]``; logits out, softmax at use.

The mean-pool runs on the device from padded token ids (a row gather and a
masked sum); the embedding table is an input, not a parameter: no gradient
reaches it, the optimizer does not see it and no checkpoint holds it.  No
hand-written kernel lies on this path: the step is the gather, two small
matrix products and Adam over four tensors.

Training mode is ``forward(pooled, seeds=...)``: per-row int32 dropout
seeds (:meth:`icl_torch.train.state.TrainState.dropout_seeds`).  The mask is
the port's hash mask (:func:`icl_torch.ops.grid_head_train.keep_mask` at
cell (0, 0)), a pure function of (row seed, hidden unit), so it is the same
on the CPU and on the GPU, and a sharded batch would reproduce the
single-device masks row by row.
"""

from __future__ import annotations

import torch

from icl_torch.models._layers import Dense, FlatParams
from icl_torch.ops.grid_head_train import (dropout_applies, dropout_scale,
                                           keep_mask)

NONVIS_CLASSES = ("visual", "nonvisual")


def mean_pool_tokens(emb_table: torch.Tensor, token_ids: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """[B, L] padded ids -> [B, D] masked mean (PAD/OOV row 0 is zeros).

    OOV tokens contribute zero vectors but still count in the denominator:
    the denominator is the true token count (at least 1).  That rules out
    ``embedding_bag(mode="mean")``, which divides by the bag's own count and
    drops a ``padding_idx`` row from it.
    """
    vecs = emb_table[token_ids.long()]                          # [B, L, D]
    L = token_ids.shape[1]
    mask = (torch.arange(L, device=token_ids.device)
            < lengths[:, None]).to(vecs.dtype)
    summed = (vecs * mask[:, :, None]).sum(dim=1)
    return summed / torch.clamp_min(lengths[:, None].to(vecs.dtype), 1.0)


def row_keep_mask(seeds: torch.Tensor, K: int, rate: float) -> torch.Tensor:
    """Dropout keep mask of a [B, K] activation from per-row seeds: the
    grid hash at cell (0, 0) -> bool [B, K]."""
    zero = torch.zeros_like(seeds)
    return keep_mask(seeds, zero, zero, K, rate)


class MentionFFNN(FlatParams):
    """``Dense(hidden, relu) -> Dropout -> Dense(num_classes)`` over pooled
    mention vectors; the body the two mention tasks share.  Submodule names
    follow the pinned param-tree paths (``dense_1/kernel``,
    ``dense_out/bias``)."""

    task = ""

    def __init__(self, emb_dim: int, hidden: int = 300, dropout: float = 0.5,
                 num_classes: int = 2,
                 device: torch.device | None = None):
        super().__init__()
        self.dropout = float(dropout)
        self.dims = {"emb_dim": emb_dim, "hidden": hidden,
                     "num_classes": num_classes}
        self.dense_1 = Dense(emb_dim, hidden, device)
        self.dense_out = Dense(hidden, num_classes, device)

    def forward(self, pooled: torch.Tensor,
                seeds: torch.Tensor | None = None) -> torch.Tensor:
        """Logits [B, C].  ``seeds`` (int32 [B]) turns training mode on:
        dropout at ``self.dropout``; None is predict (dropout off)."""
        h = torch.relu(pooled @ self.dense_1.kernel + self.dense_1.bias)
        if seeds is not None and dropout_applies(self.dropout):
            keep = row_keep_mask(seeds, h.shape[-1], self.dropout)
            h = h * torch.where(keep, dropout_scale(self.dropout), 0.0)
        return h @ self.dense_out.kernel + self.dense_out.bias

    def probs_from_tokens(self, emb_table, token_ids, lengths):
        pooled = mean_pool_tokens(emb_table, token_ids, lengths)
        return torch.softmax(self(pooled), dim=-1)


class NonvisualModel(MentionFFNN):
    """Dense(hidden, relu) -> Dropout -> Dense(2); logits out."""

    task = "nonvisual"

    def __init__(self, emb_dim: int, hidden: int = 300, dropout: float = 0.5,
                 num_classes: int = len(NONVIS_CLASSES),
                 device: torch.device | None = None):
        super().__init__(emb_dim, hidden, dropout, num_classes, device)
