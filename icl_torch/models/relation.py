"""Pairwise mention-relation classifier (counterpart of icl/models/relation.py).

4-way ``{null, coref, subset_ij, subset_ji}`` classifier over mention pairs:
a BiLSTM caption encoder (hidden H per direction over the word vectors),
mention rep = [fwd; bwd] states at the mention's first and last token
(4H), pair vector [m_i; m_j], head Dense(K, relu) -> Dropout -> Dense(O).

Each caption of the image batch is encoded once.  The head is computed in
the distributed form ``relu(m_i @ W1[:R] + m_j @ W1[R:] + b1) @ W2 + b2``,
so each mention is projected once.  Two forms:

* gather form (``fused=False``): gathers the two projections of every pair
  and runs the head on the pair rows.  Plain PyTorch throughout (the
  recurrence too): the oracle, and the CPU path.
* fused form (``fused=True``): the M x M grid head over every ordered
  mention pair, then a plain index gather of the pair cells; the recurrence
  goes through :func:`icl_torch.ops.lstm_recurrence`.  Predict runs
  :func:`icl_torch.ops.grid_head.grid_head`; training runs
  :func:`icl_torch.ops.grid_head_train.grid_head_train`, or, with a grid
  loss, :func:`~icl_torch.ops.grid_head_train.grid_head_train_loss` (the CE
  inside the kernel).  On CUDA these are hand-written kernels; on the CPU
  their wrappers run the plain versions.

``compute_dtype`` (float32 or bfloat16, the reference's ``--compute_dtype``)
is the BiLSTM's (:mod:`icl_torch.models.rnn`); the mention reps are widened
to f32 before the head's projections, as JAX promotes bf16 @ f32, so the
head's inputs are f32 either way.  In bf16 a fused model's deterministic
passes (predict, and the grid loss of a dev eval) run the grid head's bf16
fast-dot mode (``grid_head(..., fast_dot=True)``), as the reference's fused
model does.

``exact`` is the precision of the fused training kernels' head
contractions, the reference's ``exact = jax_default_matmul_precision ==
"highest"``: True (the default) runs them in exact f32, False in their
one-pass bf16 mode (:mod:`icl_torch.ops.grid_head_train`), which is the
reference's default training precision; the CLIs set it from
``--matmul_precision`` (:func:`icl_torch.cli._common.apply_precision`).
The deterministic passes stay exact in every mode, as the reference pins
its predict kernel at ``highest``.  The gather form's head is plain
PyTorch (cuBLAS, whose f32 mode the CLIs set), as the reference's unfused
model is XLA's.

Training mode is ``forward(..., seeds=...)``: per-image int32 dropout seeds.
The dropout mask is a pure function of (seed, a, b, k)
(:func:`icl_torch.ops.grid_head_train.keep_mask`), and the gather form
applies it at the pair's cell (pair_ij[..., 0], pair_ij[..., 1]), so both
forms give the same loss at any rate.
"""

from __future__ import annotations

import torch

from icl_torch.data.pairs import RELATION_CLASSES
from icl_torch.models._layers import Dense, FlatParams
from icl_torch.models.rnn import BiLSTM
from icl_torch.ops.grid_head import grid_head
from icl_torch.ops.grid_head_train import (dropout_applies, dropout_scale,
                                           grid_ce_sums, grid_head_train,
                                           grid_head_train_loss,
                                           grid_head_train_reference,
                                           keep_mask)

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


class RelationModel(FlatParams):
    """Image-batch relation model: ``forward(table, batch) -> [I, P, O]``.

    ``batch`` holds the padded arrays of ``icl.data.imagebatch`` as tensors:
    ``tokens [I,C,L]``, ``tok_len [I,C]``, ``m_cap``/``m_first``/``m_last``
    ``[I,M]`` and ``pair_ij [I,P,2]``.  Submodule names follow the pinned
    param-tree paths (``caption_bilstm/fwd/kernel``, ``head_dense/bias``,
    ...); :meth:`load_flat` takes the ``icl-export`` keys.
    """

    task = "relation"

    def __init__(self, emb_dim: int, lstm_hidden: int = 200,
                 head_hidden: int = 800, num_classes: int = 4,
                 fused: bool = False, dropout: float = 0.5,
                 device: torch.device | None = None,
                 compute_dtype: torch.dtype = torch.float32,
                 exact: bool = True):
        super().__init__()
        self.fused = fused
        self.exact = exact   # the training kernels' head contractions
        self.dropout = float(dropout)
        self.compute_dtype = compute_dtype
        # the bf16 mode of the fused model's deterministic grid head
        self.fast_dot = fused and compute_dtype == torch.bfloat16
        self.dims = {"emb_dim": emb_dim, "lstm_hidden": lstm_hidden,
                     "head_hidden": head_hidden, "num_classes": num_classes}
        self.caption_bilstm = BiLSTM(emb_dim, lstm_hidden, use_kernel=fused,
                                     device=device,
                                     compute_dtype=compute_dtype)
        self.head_dense = Dense(8 * lstm_hidden, head_hidden, device)
        self.head_out = Dense(head_hidden, num_classes, device)

    def forward(self, table: torch.Tensor, batch: dict,
                seeds: torch.Tensor | None = None,
                loss_grid: tuple | None = None):
        """Logits [I, P, O]; with ``loss_grid = (labels [I,M,M] int32,
        weights [I,M,M])`` instead the grid CE sums ``(sum ce*w, sum hits,
        sum valid)`` (see :func:`~icl_torch.ops.grid_head_train.grid_ce_sums`;
        ``weights`` gets no gradient).  ``seeds`` (int32 [I]) turns training
        mode on: dropout at ``self.dropout`` and the training kernels; None
        is predict (dropout off)."""
        tokens = batch["tokens"]
        I, C, L = tokens.shape
        x = table[tokens.reshape(I * C, L).long()]            # [I*C, L, D]
        enc_flat, _ = self.caption_bilstm(x, batch["tok_len"].reshape(I * C))
        enc = enc_flat.reshape(I, C, L, -1)
        mreps = gather_mention_reps(enc, batch["m_cap"], batch["m_first"],
                                    batch["m_last"]).float()   # [I, M, R]
        R = mreps.shape[-1]
        W1, b1 = self.head_dense.kernel, self.head_dense.bias
        W2, b2 = self.head_out.kernel, self.head_out.bias
        proj_i = mreps @ W1[:R]                                # [I, M, K]
        proj_j = mreps @ W1[R:]
        train = seeds is not None
        rate = self.dropout if train else 0.0

        if loss_grid is not None:
            labels, weights = loss_grid
            weights = weights.detach()
            if self.fused and not train and self.fast_dot:
                return grid_ce_sums(grid_head(proj_i, proj_j, b1, W2, b2,
                                              fast_dot=True), labels, weights)
            if self.fused:
                # the CE inside the kernel: only three sums leave it; a
                # deterministic pass (a dev eval) is the same kernel at
                # rate 0, where the seeds are not read
                if not train:
                    seeds = torch.zeros(I, dtype=torch.int32,
                                        device=tokens.device)
                return grid_head_train_loss(proj_i, proj_j, b1, W2, b2,
                                            seeds, labels, weights, rate,
                                            self.exact or not train)
            # plain oracle: materialises the [I, M, M, K] activation
            grid = grid_head_train_reference(proj_i, proj_j, b1, W2, b2,
                                             seeds, rate)
            return grid_ce_sums(grid, labels, weights)

        pi, pj = batch["pair_ij"][..., 0].long(), batch["pair_ij"][..., 1].long()
        img = torch.arange(I, device=tokens.device)[:, None]
        if self.fused:
            grid = (grid_head_train(proj_i, proj_j, b1, W2, b2, seeds, rate,
                                    self.exact)
                    if train else grid_head(proj_i, proj_j, b1, W2, b2,
                                            fast_dot=self.fast_dot))
            return grid[img, pi, pj]                           # [I, P, O]
        h = torch.relu(proj_i[img, pi] + proj_j[img, pj] + b1)
        if train and dropout_applies(rate):
            keep = keep_mask(seeds[:, None], pi, pj, h.shape[-1], rate)
            h = h * torch.where(keep, dropout_scale(rate), 0.0)
        return h @ W2 + b2
