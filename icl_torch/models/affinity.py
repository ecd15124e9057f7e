"""Phrase-box affinity model (counterpart of icl/models/affinity.py).

Per (mention, box) of an image: ``[phrase embedding ; box features] ->
Dense(K, relu) -> Dropout -> Dense(2)``, class order ``[no_affinity,
affinity]``.  The phrase embedding is the final state of a one-direction
LSTM over the phrase's word vectors (``phrase_enc="lstm"``) or their mean
(``"mean_w2v"``; a length-0 phrase gives zeros either way).  The
concatenation into the first Dense layer distributes over its weight, so
the head is ``relu(X[a] + Y[b] + b1) @ W2 + b2`` with ``X = phrase @ Wp``
and ``Y = boxes @ Wb`` (two plain GEMMs; each row is projected once).  Two
forms:

* plain form (``fused=False``): materialises the [I, M, B, K] grid
  activation in plain PyTorch (the recurrence too): the oracle, and the CPU
  path.
* fused form (``fused=True``): predict runs
  :func:`icl_torch.ops.grid_head.grid_head`; training runs
  :func:`~icl_torch.ops.grid_head_train.grid_head_train`, or, with a grid
  loss, :func:`~icl_torch.ops.grid_head_train.grid_head_train_loss`; the
  recurrence goes through :func:`icl_torch.ops.lstm_recurrence`.  On CUDA
  these are hand-written kernels; on the CPU their wrappers run the plain
  versions.

``compute_dtype`` (float32 or bfloat16) is that of the phrase encoder (the
LSTM, or the mean of the word vectors); the phrase embedding and the box
features are widened to f32 before the two projections, as JAX promotes
bf16 @ f32.  In bf16 a fused model's deterministic passes run the grid
head's fast-dot mode, and its box ranking the box-ranking kernel's
(:func:`icl_torch.train.steps.affinity_predict`).  ``exact`` picks the
training kernels' precision, exact f32 (the default) or their one-pass
bf16 mode, as in :mod:`icl_torch.models.relation`.

Training mode is ``forward(..., seeds=...)``: per-image int32 dropout
seeds, and the same hash mask of (seed, a, b, k) in both forms, so both
give one loss at any rate.  :func:`rank_boxes` is the one source of the
ranking's masking convention.
"""

from __future__ import annotations

import torch

from icl_torch.models._layers import Dense, FlatParams
from icl_torch.models.rnn import LSTM
from icl_torch.ops.grid_head import grid_head
from icl_torch.ops.grid_head_train import (grid_ce_sums, grid_head_train,
                                           grid_head_train_loss,
                                           grid_head_train_reference)

__all__ = ["AFFINITY_CLASSES", "AffinityModel", "rank_boxes"]

AFFINITY_CLASSES = ("no_affinity", "affinity")
PHRASE_ENCODERS = ("lstm", "mean_w2v")


class AffinityModel(FlatParams):
    """Image-grid affinity model: ``forward(table, batch) -> [I, M, B, O]``.

    ``batch`` holds the padded arrays of ``icl.data.imagebatch.
    AffinityBatcher`` as tensors: ``phrase_tokens [I,M,L]``, ``phrase_len
    [I,M]``, ``box_feats [I,B,D]`` (and ``box_valid [I,B]`` for ranking).
    Submodule names follow the pinned param-tree paths (``phrase_lstm/
    kernel``, ``head_dense_phrase/bias``, ``head_dense_box/kernel``, ...).
    """

    task = "affinity"

    def __init__(self, emb_dim: int, box_dim: int, lstm_hidden: int = 200,
                 head_hidden: int = 1024, num_classes: int = 2,
                 phrase_enc: str = "lstm", fused: bool = False,
                 dropout: float = 0.5, device: torch.device | None = None,
                 compute_dtype: torch.dtype = torch.float32,
                 exact: bool = True):
        super().__init__()
        if phrase_enc not in PHRASE_ENCODERS:
            raise ValueError(f"unknown phrase_enc {phrase_enc!r}")
        self.fused = fused
        self.exact = exact   # the training kernels' head contractions
        self.dropout = float(dropout)
        self.phrase_enc = phrase_enc
        self.compute_dtype = compute_dtype
        # the bf16 mode of the fused model's deterministic grid head
        self.fast_dot = fused and compute_dtype == torch.bfloat16
        self.dims = {"emb_dim": emb_dim, "box_dim": box_dim,
                     "lstm_hidden": lstm_hidden, "head_hidden": head_hidden,
                     "num_classes": num_classes, "phrase_enc": phrase_enc}
        Dp = emb_dim
        if phrase_enc == "lstm":
            self.phrase_lstm = LSTM(emb_dim, lstm_hidden, use_kernel=fused,
                                    device=device,
                                    compute_dtype=compute_dtype)
            Dp = lstm_hidden
        self.head_dense_phrase = Dense(Dp, head_hidden, device)
        self.head_dense_box = Dense(box_dim, head_hidden, device,
                                    use_bias=False)
        self.head_out = Dense(head_hidden, num_classes, device)

    def project(self, table: torch.Tensor, batch: dict):
        """The split head's two sides: X [I,M,K] (phrases) and Y [I,B,K]
        (boxes); the phrase-side bias is the grid head's b1."""
        toks = batch["phrase_tokens"]
        plen = batch["phrase_len"].reshape(-1)
        I, M, L = toks.shape
        x = table[toks.reshape(I * M, L).long()]              # [I*M, L, D]
        if self.phrase_enc == "lstm":
            _, ph = self.phrase_lstm(x, plen)
        else:
            x = x.to(self.compute_dtype)
            mask = (torch.arange(L, device=x.device)[None, :]
                    < plen[:, None]).to(x.dtype)
            ph = torch.einsum("bld,bl->bd", x, mask) / torch.clamp_min(
                plen[:, None].to(x.dtype), 1.0)
        X = ph.float().reshape(I, M, -1) @ self.head_dense_phrase.kernel
        Y = batch["box_feats"].float() @ self.head_dense_box.kernel
        return X, Y

    def head(self, X: torch.Tensor, Y: torch.Tensor,
             seeds: torch.Tensor | None = None,
             loss_grid: tuple | None = None):
        """Logits [I,M,B,O] of the grid; with ``loss_grid = (labels [I,M,B]
        int32, weights [I,M,B])`` instead the grid CE sums ``(sum ce*w, sum
        hits, sum valid)`` (``weights`` gets no gradient).  ``seeds`` (int32
        [I]) turns training mode on: dropout at ``self.dropout`` and the
        training kernels; None is predict (dropout off)."""
        b1 = self.head_dense_phrase.bias
        W2, b2 = self.head_out.kernel, self.head_out.bias
        train = seeds is not None
        rate = self.dropout if train else 0.0
        if loss_grid is not None:
            labels, weights = loss_grid
            weights = weights.detach()
            if self.fused and not train and self.fast_dot:
                return grid_ce_sums(grid_head(X, Y, b1, W2, b2,
                                              fast_dot=True), labels, weights)
            if self.fused:
                # the CE inside the kernel: only three sums leave it; a
                # deterministic pass (a dev eval) is the same kernel at
                # rate 0, where the seeds are not read
                if not train:
                    seeds = torch.zeros(X.shape[0], dtype=torch.int32,
                                        device=X.device)
                return grid_head_train_loss(X, Y, b1, W2, b2, seeds, labels,
                                            weights, rate,
                                            self.exact or not train)
            return grid_ce_sums(self.head(X, Y, seeds), labels, weights)
        if not self.fused:
            # plain oracle: materialises the [I, M, B, K] activation
            return grid_head_train_reference(X, Y, b1, W2, b2, seeds, rate)
        if train:
            return grid_head_train(X, Y, b1, W2, b2, seeds, rate, self.exact)
        return grid_head(X, Y, b1, W2, b2, fast_dot=self.fast_dot)

    def forward(self, table: torch.Tensor, batch: dict,
                seeds: torch.Tensor | None = None,
                loss_grid: tuple | None = None):
        """:meth:`head` over :meth:`project`."""
        X, Y = self.project(table, batch)
        return self.head(X, Y, seeds, loss_grid)


def rank_boxes(logits: torch.Tensor, box_valid: torch.Tensor,
               affinity_col: int = 1) -> torch.Tensor:
    """Per-image ranking distribution over candidate boxes.

    Softmax over the box axis of the affinity-class logit, masked to valid
    boxes: [I,M,B,O] logits + [I,B] validity -> [I,M,B].  Invalid boxes get
    exactly 0 and an image with no valid box all zeros, not NaN.  The one
    source of the masking convention: K9's plain version
    (:func:`icl_torch.ops.affinity_rank.affinity_rank_reference`) composes
    it.
    """
    aff = logits[..., affinity_col]                           # [I, M, B]
    valid = box_valid[:, None, :]
    masked = torch.where(valid, aff, torch.finfo(aff.dtype).min)
    probs = torch.softmax(masked, dim=-1)
    any_valid = box_valid.any(dim=-1)[:, None, None]
    return torch.where(any_valid, probs * valid, 0.0)
