"""Keras masked LSTM / BiLSTM, forward only (counterpart of icl/models/rnn.py).

Parameters keep the Keras layouts the JAX package pins: ``kernel [D, 4H]``,
``recurrent_kernel [H, 4H]``, ``bias [4H]``, gate slabs i, f, c~, o.  At a
padded step the carry passes through, so outputs at positions >= length
hold the last valid state and ``final`` is the state at the last valid
step.  The input projection is one plain matmul for all steps (and, in the
BiLSTM, both directions); the recurrence goes to
:func:`icl_torch.ops.lstm_recurrence` (the hand-written kernel on CUDA)
when ``use_kernel`` is set, else to its plain version.

Parameters start at zero; real values come from ``load_state_dict`` (see
:meth:`icl_torch.models.relation.RelationModel.load_flat`).
"""

from __future__ import annotations

import torch
from torch import nn

from icl_torch.ops.lstm_recurrence import (lstm_recurrence,
                                           lstm_recurrence_reference)


class LSTMParams(nn.Module):
    """``kernel``, ``recurrent_kernel`` and ``bias`` of one LSTM."""

    def __init__(self, in_dim: int, hidden: int,
                 device: torch.device | None = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_dim, 4 * hidden,
                                               device=device))
        self.recurrent_kernel = nn.Parameter(torch.zeros(hidden, 4 * hidden,
                                                         device=device))
        self.bias = nn.Parameter(torch.zeros(4 * hidden, device=device))


def _recurrence(use_kernel: bool):
    return lstm_recurrence if use_kernel else lstm_recurrence_reference


class LSTM(LSTMParams):
    """Unidirectional masked LSTM: [B, L, D], lengths [B] -> ([B, L, H],
    final [B, H]).  ``reverse`` runs from the last valid token backwards."""

    def __init__(self, in_dim: int, hidden: int, reverse: bool = False,
                 use_kernel: bool = True,
                 device: torch.device | None = None):
        super().__init__(in_dim, hidden, device)
        self.reverse = reverse
        self.recurrence = _recurrence(use_kernel)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        B, L, D = x.shape
        t = torch.arange(L, device=x.device)
        xt = x.transpose(0, 1)                                # [L, B, D]
        if self.reverse:
            xt = xt.flip(0)
            t = L - 1 - t
        mask = t[:, None] < lengths[None, :]                  # [L, B]
        x_proj = xt @ self.kernel + self.bias                 # [L, B, 4H]
        hs, h_final = self.recurrence(x_proj[None], mask[None],
                                      self.recurrent_kernel[None])
        out = hs[0].transpose(0, 1)                           # [B, L, H]
        if self.reverse:
            out = out.flip(1)
        return out, h_final[0]


class BiLSTM(nn.Module):
    """[B, L, D], lengths [B] -> (seq [B, L, 2H] = [fwd_h_t; bwd_h_t],
    final [B, 2H]).

    Both directions run as one G=2 recurrence; the backward copy is
    time-reversed, so bwd_h_t encodes tokens t .. length-1.
    """

    def __init__(self, in_dim: int, hidden: int, use_kernel: bool = True,
                 device: torch.device | None = None):
        super().__init__()
        self.fwd = LSTMParams(in_dim, hidden, device)
        self.bwd = LSTMParams(in_dim, hidden, device)
        self.recurrence = _recurrence(use_kernel)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        B, L, D = x.shape
        xt = x.transpose(0, 1)                                # [L, B, D]
        xs2 = torch.stack([xt, xt.flip(0)]).reshape(2, L * B, D)
        K2 = torch.stack([self.fwd.kernel, self.bwd.kernel])  # [2, D, 4H]
        b2 = torch.stack([self.fwd.bias, self.bwd.bias])      # [2, 4H]
        R2 = torch.stack([self.fwd.recurrent_kernel,
                          self.bwd.recurrent_kernel])         # [2, H, 4H]
        # input projection for both directions in one batched GEMM
        x_proj = (torch.bmm(xs2, K2) + b2[:, None, :]).reshape(2, L, B, -1)
        t = torch.arange(L, device=x.device)
        mask2 = torch.stack([t[:, None] < lengths[None, :],
                             (L - 1 - t)[:, None] < lengths[None, :]])
        hs, h_final = self.recurrence(x_proj, mask2, R2)     # [2, L, B, H]
        fwd_seq = hs[0].transpose(0, 1)                       # [B, L, H]
        bwd_seq = hs[1].flip(0).transpose(0, 1)
        seq = torch.cat([fwd_seq, bwd_seq], dim=-1)
        return seq, torch.cat([h_final[0], h_final[1]], dim=-1)
