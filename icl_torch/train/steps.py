"""Train and predict steps of the four tasks (counterpart of
icl/train/steps.py).

The mention tasks (nonvisual, cardinality) take flat ``[N, L]`` token
batches: mean-pool, FFNN, :func:`masked_weighted_ce` without class weights.
Relation and affinity take image batches.  All losses are masked cross-entropies: padded pairs and cells contribute
zero loss and zero gradient, and the normaliser is the (class-weighted)
count of valid examples.  Two train forms per task, as in the reference:

* pair form (relation) or cell form (affinity): the model's logits,
  :func:`masked_weighted_ce`;
* grid-loss form (``grid_loss=True``): labels in grid form (the batcher's
  ``grid_label``/``grid_valid``; for relation batches without them, a
  device scatter of the pair list) and the model's grid CE sums; on a fused
  model the CE runs inside the training grid-head kernel and the logits
  never reach device memory.  Same loss and accuracy as the other form over
  the same cells.

A class weight <= 0 turns the grid-loss form off (see
:func:`make_relation_train_step`).
"""

from __future__ import annotations

from typing import Callable

import torch

from icl_torch.util.log import LOG
from icl_torch.models.affinity import AffinityModel, rank_boxes
from icl_torch.models.nonvisual import MentionFFNN, mean_pool_tokens
from icl_torch.models.relation import RelationModel
from icl_torch.ops.affinity_rank import affinity_rank
from icl_torch.ops.ce import onehot_ce
from icl_torch.train.state import TrainState


def masked_weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor,
                       class_weights: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Mean CE over valid entries, optionally weighted per class."""
    ce, onehot = onehot_ce(logits, labels)
    w = valid.to(ce.dtype)
    if class_weights is not None:
        w = w * (onehot * class_weights).sum(dim=-1)
    return (ce * w).sum() / torch.clamp_min(w.sum(), 1.0)


def _accuracy(logits, labels, valid):
    hit = (logits.argmax(dim=-1) == labels) & valid
    return hit.sum() / torch.clamp_min(valid.sum(), 1)


# ---------------------------------------------------------------------------
# Mention-level tasks (nonvisual, cardinality): flat [N, L] token batches
# ---------------------------------------------------------------------------

def mention_loss(model: MentionFFNN, table: torch.Tensor,
                 token_ids: torch.Tensor, lengths: torch.Tensor,
                 labels: torch.Tensor, valid: torch.Tensor,
                 seeds: torch.Tensor | None) -> tuple[torch.Tensor, dict]:
    """The mention train loss and its metrics, before any update:
    ``(loss, {"loss", "acc"})``.  ``seeds``: per-row dropout seeds (None: no
    dropout).  The table is an input: it gets no gradient."""
    pooled = mean_pool_tokens(table.detach(), token_ids, lengths)
    return _logit_loss(model(pooled, seeds=seeds), labels, valid, None)


def make_mention_train_step() -> Callable:
    """``step(state, table, token_ids, lengths, labels, valid) -> metrics``
    for the FFNN-over-mean-word-vector tasks: one Adam update in place.
    After the step, the parameters' ``.grad`` hold the step's gradients."""

    def train_step(state: TrainState, table: torch.Tensor,
                   token_ids: torch.Tensor, lengths: torch.Tensor,
                   labels: torch.Tensor, valid: torch.Tensor) -> dict:
        seeds = state.dropout_seeds(token_ids.shape[0])
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = mention_loss(state.model, table, token_ids, lengths,
                                     labels, valid, seeds)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def mention_predict(model: MentionFFNN, table: torch.Tensor,
                    token_ids: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Class probabilities [N, C] of padded mention token rows."""
    with torch.inference_mode():
        return model.probs_from_tokens(table, token_ids, lengths)


# ---------------------------------------------------------------------------
# Relation and affinity: image batches
# ---------------------------------------------------------------------------

def _cell_weights(labels, valid, cw):
    """``valid * class_weight[label]``; 0 for labels outside the table."""
    w = valid.to(torch.float32)
    if cw is None:
        return w
    sel = torch.zeros(labels.shape, dtype=torch.float32, device=labels.device)
    for k in range(cw.shape[0]):
        sel = torch.where(labels == k, cw[k], sel)
    return w * sel


def _grid_cells(batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(grid_label int32 [I,M,M], grid_valid bool [I,M,M]): the batcher's,
    or scattered from the pair list (its cells are distinct; padded pairs
    add zeros)."""
    if "grid_label" in batch:
        return batch["grid_label"].to(torch.int32), batch["grid_valid"]
    pij, pv = batch["pair_ij"].long(), batch["pair_valid"]
    I, M = pv.shape[0], batch["m_cap"].shape[1]
    idx = (torch.arange(I, device=pv.device)[:, None].expand_as(pv),
           pij[..., 0], pij[..., 1])
    glabel = torch.zeros((I, M, M), dtype=torch.int32, device=pv.device)
    glabel.index_put_(idx, torch.where(pv, batch["pair_label"], 0).to(
        torch.int32), accumulate=True)
    gvalid = torch.zeros((I, M, M), dtype=torch.int32, device=pv.device)
    gvalid.index_put_(idx, pv.to(torch.int32), accumulate=True)
    return glabel, gvalid > 0


def _grid_loss(model, table, batch, seeds, glabel, gvalid, class_weights):
    """The grid-loss form: the model's grid CE sums over the cells of
    weight ``gvalid * class_weight[label]`` -> (loss, metrics)."""
    gweight = _cell_weights(glabel, gvalid, class_weights)
    loss_sum, hits, nval = model(table, batch, seeds=seeds,
                                 loss_grid=(glabel, gweight))
    loss = loss_sum / torch.clamp_min(gweight.sum(), 1.0)
    return loss, {"loss": loss, "acc": hits / torch.clamp_min(nval, 1.0),
                  "hits": hits, "nvalid": nval}


def _logit_loss(logits, labels, valid, class_weights):
    loss = masked_weighted_ce(logits, labels, valid, class_weights)
    return loss, {"loss": loss, "acc": _accuracy(logits, labels, valid)}


def relation_loss(model: RelationModel, table: torch.Tensor, batch: dict,
                  seeds: torch.Tensor | None,
                  class_weights: torch.Tensor | None = None,
                  grid_loss: bool = False) -> tuple[torch.Tensor, dict]:
    """The train loss and its metrics, before any update.

    Returns ``(loss, {"loss", "acc"})``; the grid-loss form adds ``hits``
    and ``nvalid``.  ``seeds``: per-image dropout seeds (None: no dropout).
    """
    if grid_loss:
        return _grid_loss(model, table, batch, seeds, *_grid_cells(batch),
                          class_weights)
    return _logit_loss(model(table, batch, seeds=seeds), batch["pair_label"],
                       batch["pair_valid"], class_weights)


def affinity_loss(model: AffinityModel, table: torch.Tensor, batch: dict,
                  seeds: torch.Tensor | None,
                  class_weights: torch.Tensor | None = None,
                  grid_loss: bool = False) -> tuple[torch.Tensor, dict]:
    """As :func:`relation_loss`, over the (mention, box) cells: the labels
    are grid-shaped already (``grid_label``/``grid_valid``), so the cell
    form is :func:`masked_weighted_ce` over the logit grid."""
    glabel, gvalid = batch["grid_label"].to(torch.int32), batch["grid_valid"]
    if grid_loss:
        return _grid_loss(model, table, batch, seeds, glabel, gvalid,
                          class_weights)
    return _logit_loss(model(table, batch, seeds=seeds), glabel, gvalid,
                       class_weights)


def _make_train_step(loss_fn, images_key: str, class_weights, grid_loss,
                     other_form: str) -> Callable:
    if grid_loss and class_weights is not None and any(
            w <= 0 for w in class_weights):
        LOG.warning("grid_loss disabled: a class weight <= 0 would drop "
                    "that class from the in-kernel accuracy denominator; "
                    "keeping the %s-form step for consistent metrics",
                    other_form)
        grid_loss = False

    cw_on: dict[torch.device, torch.Tensor] = {}   # built once a device

    def class_weight_tensor(device: torch.device) -> torch.Tensor | None:
        if class_weights is None:
            return None
        if device not in cw_on:
            cw_on[device] = torch.as_tensor(class_weights,
                                            dtype=torch.float32,
                                            device=device)
        return cw_on[device]

    def train_step(state: TrainState, table: torch.Tensor,
                   batch: dict) -> dict:
        cw = class_weight_tensor(table.device)
        seeds = state.dropout_seeds(batch[images_key].shape[0])
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state.model, table, batch, seeds, cw,
                                grid_loss)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    train_step.grid_loss = grid_loss
    train_step.class_weight_tensor = class_weight_tensor
    return train_step


def make_relation_train_step(class_weights=None,
                             grid_loss: bool = False) -> Callable:
    """``step(state, table, batch) -> metrics``: one Adam update in place.

    ``grid_loss=True`` (the fused production mode) computes the CE over the
    M x M grid.  Its accuracy counts cells of weight > 0, so a class weight
    <= 0 would drop that class from the accuracy's denominator; then the
    pair form is kept instead, so metric meanings never depend on the form.
    After the step, the parameters' ``.grad`` hold the step's gradients.
    """
    return _make_train_step(relation_loss, "tokens", class_weights,
                            grid_loss, "pair")


def make_affinity_train_step(class_weights=None,
                             grid_loss: bool = False) -> Callable:
    """As :func:`make_relation_train_step` for the affinity model; a class
    weight <= 0 keeps the cell form."""
    return _make_train_step(affinity_loss, "phrase_tokens", class_weights,
                            grid_loss, "cell")


def relation_predict(model: RelationModel, table: torch.Tensor,
                     batch: dict) -> torch.Tensor:
    """Relation class probabilities [I, P, 4] (softmax over the logits)."""
    with torch.inference_mode():
        return torch.softmax(model(table, batch), dim=-1)


def affinity_predict(model: AffinityModel, table: torch.Tensor, batch: dict,
                     rank: bool = False):
    """Affinity class probabilities [I, M, B, 2] (softmax over the logits).

    With ``rank=True`` returns ``(probs, ranking)``: ``ranking [I, M, B]``
    is the per-image softmax of the affinity logit over the valid boxes
    (``batch["box_valid"]``), the ranking a ``--rank_file`` writes.  A
    fused model computes it with the box-ranking kernel
    (:func:`icl_torch.ops.affinity_rank.affinity_rank`), a plain one with
    :func:`~icl_torch.models.affinity.rank_boxes` over its logits.
    """
    with torch.inference_mode():
        X, Y = model.project(table, batch)
        logits = model.head(X, Y)
        probs = torch.softmax(logits, dim=-1)
        if not rank:
            return probs
        box_valid = batch["box_valid"]
        if model.fused:
            ranking = affinity_rank(X, Y, model.head_dense_phrase.bias,
                                    model.head_out.kernel,
                                    model.head_out.bias, box_valid)
        else:
            ranking = rank_boxes(logits, box_valid)
        return probs, ranking
