"""One-hot max-shift cross-entropy, the shared per-cell CE definition.

Counterpart of ``icl/ops/ce.py``.  The pair-form loss
(:func:`icl_torch.train.steps.masked_weighted_ce`), the grid loss
(:func:`icl_torch.ops.grid_head_train.grid_ce_sums`) and the in-kernel CE of
``csrc/grid_head_train.cu`` all follow this math, so the pair-form and
grid-form training losses cannot drift apart.
"""

from __future__ import annotations

import torch


def onehot_ce(logits: torch.Tensor, labels: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cell CE over the minor class axis; returns ``(ce, onehot)``.

    The max shift is detached, as in the reference.  A label outside
    ``[0, O)`` gives a zero one-hot row (its CE is then ``logsumexp``; the
    caller's validity weights mask it).
    """
    lmax = logits.max(dim=-1, keepdim=True).values.detach()
    sh = logits - lmax
    logz = torch.log(torch.exp(sh).sum(dim=-1))
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels[..., None] == classes).to(logits.dtype)
    return logz - (sh * onehot).sum(dim=-1), onehot
