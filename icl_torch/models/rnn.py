"""Keras masked LSTM / BiLSTM (counterpart of icl/models/rnn.py).

Parameters keep the Keras layouts the JAX package pins: ``kernel [D, 4H]``,
``recurrent_kernel [H, 4H]``, ``bias [4H]``, gate slabs i, f, c~, o.  At a
padded step the carry passes through, so outputs at positions >= length
hold the last valid state and ``final`` is the state at the last valid
step.  The input projection is one plain matmul for all steps (and, in the
BiLSTM, both directions); the recurrence goes to
:func:`icl_torch.ops.lstm_recurrence` (the hand-written kernel on CUDA, and
the reference's residual-set backward: on CUDA a second kernel, all steps
in one launch, in f32 and bf16 alike; on the CPU a plain reverse loop) when
``use_kernel`` is set, else to its plain version (differentiated by
autograd step by step).  The kernels
take at most ``MAX_H`` (512) units: a wider LSTM on CUDA is refused when
the layer is built (:func:`check_lstm_width`), naming ``--fused off``, the
explicit way to the plain recurrence.

``compute_dtype`` (float32 or bfloat16, as the reference's): the inputs and
the kernel, bias and recurrent kernel are cast to it before the input
projection, which and the recurrence then run in it; the states come back
in it.  The parameters stay f32 (their gradients flow back through the
casts).

Parameters start at zero; real values come from ``load_state_dict`` (see
:meth:`icl_torch.models.relation.RelationModel.load_flat`).
"""

from __future__ import annotations

import torch
from torch import nn

from icl_torch.ops.lstm_recurrence import (MAX_H, lstm_recurrence,
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


def check_lstm_width(hidden: int, use_kernel: bool,
                     device: torch.device | str | None) -> None:
    """Refuse, when the layer is built, an LSTM the recurrence kernel
    cannot run: ``use_kernel`` on CUDA with more than ``MAX_H`` units.
    There is no quiet plain-loop fallback on the card; ``--fused off``
    asks for the plain recurrence."""
    if use_kernel and torch.device(device or "cpu").type == "cuda" \
            and hidden > MAX_H:
        raise ValueError(
            f"--lstm_hidden_width {hidden}: the recurrence kernel takes at "
            f"most {MAX_H} units on CUDA; use a narrower LSTM, or --fused "
            f"off for the plain PyTorch path")


def _recurrence(hidden: int, use_kernel: bool, device):
    check_lstm_width(hidden, use_kernel, device)
    return lstm_recurrence if use_kernel else lstm_recurrence_reference


class LSTM(LSTMParams):
    """Unidirectional masked LSTM: [B, L, D], lengths [B] -> ([B, L, H],
    final [B, H]).  ``reverse`` runs from the last valid token backwards."""

    def __init__(self, in_dim: int, hidden: int, reverse: bool = False,
                 use_kernel: bool = True,
                 device: torch.device | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_dim, hidden, device)
        self.reverse = reverse
        self.recurrence = _recurrence(hidden, use_kernel, device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        B, L, D = x.shape
        cd = self.compute_dtype
        t = torch.arange(L, device=x.device)
        xt = x.to(cd).transpose(0, 1)                         # [L, B, D]
        if self.reverse:
            xt = xt.flip(0)
            t = L - 1 - t
        mask = t[:, None] < lengths[None, :]                  # [L, B]
        x_proj = xt @ self.kernel.to(cd) + self.bias.to(cd)   # [L, B, 4H]
        hs, h_final = self.recurrence(x_proj[None], mask[None],
                                      self.recurrent_kernel.to(cd)[None])
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
                 device: torch.device | None = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fwd = LSTMParams(in_dim, hidden, device)
        self.bwd = LSTMParams(in_dim, hidden, device)
        self.recurrence = _recurrence(hidden, use_kernel, device)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        B, L, D = x.shape
        cd = self.compute_dtype
        xt = x.to(cd).transpose(0, 1)                         # [L, B, D]
        xs2 = torch.stack([xt, xt.flip(0)]).reshape(2, L * B, D)
        K2 = torch.stack([self.fwd.kernel, self.bwd.kernel]).to(cd)
        b2 = torch.stack([self.fwd.bias, self.bwd.bias]).to(cd)
        R2 = torch.stack([self.fwd.recurrent_kernel,
                          self.bwd.recurrent_kernel]).to(cd)  # [2, H, 4H]
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
