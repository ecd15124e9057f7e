"""Pairwise mention-relation classifier (counterpart of icl/models/relation.py).

4-way ``{null, coref, subset_ij, subset_ji}`` classifier over mention pairs:
a BiLSTM caption encoder (hidden H per direction over the word vectors),
mention rep = [fwd; bwd] states at the mention's first and last token
(4H), pair vector [m_i; m_j], head Dense(K, relu) -> Dense(O).  Predict
only: dropout is the identity.

Each caption of the image batch is encoded once.  The head is computed in
the distributed form ``relu(m_i @ W1[:R] + m_j @ W1[R:] + b1) @ W2 + b2``,
so each mention is projected once.  Two forms:

* gather form (``fused=False``): gathers the two projections of every pair
  and runs the head on the pair rows.  Plain PyTorch throughout (the
  recurrence too): the oracle, and the CPU path.
* fused form (``fused=True``): the M x M grid head
  (:func:`icl_torch.ops.grid_head`) over every ordered mention pair, then a
  plain index gather of the pair cells; the recurrence goes through
  :func:`icl_torch.ops.lstm_recurrence`.  On CUDA both are hand-written
  kernels; on the CPU both wrappers run their plain versions.
"""

from __future__ import annotations

import torch
from torch import nn

from icl.data.pairs import RELATION_CLASSES
from icl_torch.models.rnn import BiLSTM
from icl_torch.ops.grid_head import grid_head

__all__ = ["RelationModel", "RELATION_CLASSES", "gather_mention_reps"]


def gather_mention_reps(enc: torch.Tensor, m_cap: torch.Tensor,
                        m_first: torch.Tensor,
                        m_last: torch.Tensor) -> torch.Tensor:
    """[I,C,L,2H] encoded captions + [I,M] span tables -> [I,M,4H] reps.

    rep = [enc[cap, first]; enc[cap, last]], as two flat row gathers.
    """
    I, C, L, twoH = enc.shape
    flat = enc.reshape(I * C * L, twoH)
    img_off = torch.arange(I, device=enc.device)[:, None] * C
    row = (img_off + m_cap.long()) * L                        # [I, M]
    return torch.cat([flat[row + m_first.long()],
                      flat[row + m_last.long()]], dim=-1)


class Dense(nn.Module):
    """``kernel [in, out]`` and ``bias [out]`` in the Keras layout."""

    def __init__(self, in_features: int, features: int,
                 device: torch.device | None = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))


class RelationModel(nn.Module):
    """Image-batch relation model: ``forward(table, batch) -> [I, P, O]``.

    ``batch`` holds the padded arrays of ``icl.data.imagebatch`` as tensors:
    ``tokens [I,C,L]``, ``tok_len [I,C]``, ``m_cap``/``m_first``/``m_last``
    ``[I,M]`` and ``pair_ij [I,P,2]``.  Submodule names follow the pinned
    param-tree paths (``caption_bilstm/fwd/kernel``, ``head_dense/bias``,
    ...); :meth:`load_flat` takes the ``icl-export`` keys.
    """

    def __init__(self, emb_dim: int, lstm_hidden: int = 200,
                 head_hidden: int = 800, num_classes: int = 4,
                 fused: bool = False, device: torch.device | None = None):
        super().__init__()
        self.fused = fused
        self.caption_bilstm = BiLSTM(emb_dim, lstm_hidden, use_kernel=fused,
                                     device=device)
        self.head_dense = Dense(8 * lstm_hidden, head_hidden, device)
        self.head_out = Dense(head_hidden, num_classes, device)

    def load_flat(self, flat: dict[str, torch.Tensor]) -> None:
        """Copy ``icl-export`` keyed weights in; raises on any key or shape
        mismatch."""
        self.load_state_dict({k.replace("/", "."): v
                              for k, v in flat.items()})

    def flat_params(self) -> dict[str, torch.Tensor]:
        return {k.replace(".", "/"): v for k, v in self.state_dict().items()}

    def forward(self, table: torch.Tensor, batch: dict) -> torch.Tensor:
        tokens = batch["tokens"]
        I, C, L = tokens.shape
        x = table[tokens.reshape(I * C, L).long()]            # [I*C, L, D]
        enc_flat, _ = self.caption_bilstm(x, batch["tok_len"].reshape(I * C))
        enc = enc_flat.reshape(I, C, L, -1)
        mreps = gather_mention_reps(enc, batch["m_cap"], batch["m_first"],
                                    batch["m_last"])           # [I, M, R]
        R = mreps.shape[-1]
        W1, b1 = self.head_dense.kernel, self.head_dense.bias
        W2, b2 = self.head_out.kernel, self.head_out.bias
        proj_i = mreps @ W1[:R]                                # [I, M, K]
        proj_j = mreps @ W1[R:]
        pair_ij = batch["pair_ij"].long()
        img = torch.arange(I, device=tokens.device)[:, None]
        if self.fused:
            grid = grid_head(proj_i, proj_j, b1, W2, b2)       # [I, M, M, O]
            return grid[img, pair_ij[..., 0], pair_ij[..., 1]]
        h = (proj_i[img, pair_ij[..., 0]] + proj_j[img, pair_ij[..., 1]]
             + b1)
        return torch.relu(h) @ W2 + b2
