"""Relation train and predict steps (counterpart of icl/train/steps.py).

All losses are masked cross-entropies: padded pairs and cells contribute
zero loss and zero gradient, and the normaliser is the (class-weighted)
count of valid examples.  Two train forms, as in the reference:

* pair form: the model's pair logits, :func:`masked_weighted_ce`;
* grid-loss form (``grid_loss=True``): pair labels in M x M grid form (the
  batcher's ``grid_label``/``grid_valid``, or a device scatter for batches
  without them) and the model's grid CE sums; on a fused model the CE runs
  inside the training grid-head kernel and the logits never reach device
  memory.  Same loss and accuracy as the pair form over the same cells.
"""

from __future__ import annotations

from typing import Callable

import torch

from icl.util.log import LOG
from icl_torch.models.relation import RelationModel
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


def relation_loss(model: RelationModel, table: torch.Tensor, batch: dict,
                  seeds: torch.Tensor | None,
                  class_weights: torch.Tensor | None = None,
                  grid_loss: bool = False) -> tuple[torch.Tensor, dict]:
    """The train loss and its metrics, before any update.

    Returns ``(loss, {"loss", "acc"})``; the grid-loss form adds ``hits``
    and ``nvalid``.  ``seeds``: per-image dropout seeds (None: no dropout).
    """
    if grid_loss:
        glabel, gvalid = _grid_cells(batch)
        gweight = _cell_weights(glabel, gvalid, class_weights)
        loss_sum, hits, nval = model(table, batch, seeds=seeds,
                                     loss_grid=(glabel, gweight))
        loss = loss_sum / torch.clamp_min(gweight.sum(), 1.0)
        return loss, {"loss": loss, "acc": hits / torch.clamp_min(nval, 1.0),
                      "hits": hits, "nvalid": nval}
    logits = model(table, batch, seeds=seeds)
    loss = masked_weighted_ce(logits, batch["pair_label"],
                              batch["pair_valid"], class_weights)
    return loss, {"loss": loss,
                  "acc": _accuracy(logits, batch["pair_label"],
                                   batch["pair_valid"])}


def make_relation_train_step(class_weights=None,
                             grid_loss: bool = False) -> Callable:
    """``step(state, table, batch) -> metrics``: one Adam update in place.

    ``grid_loss=True`` (the fused production mode) computes the CE over the
    M x M grid.  Its accuracy counts cells of weight > 0, so a class weight
    <= 0 would drop that class from the accuracy's denominator; then the
    pair form is kept instead, so metric meanings never depend on the form.
    After the step, the parameters' ``.grad`` hold the step's gradients.
    """
    if grid_loss and class_weights is not None and any(
            w <= 0 for w in class_weights):
        LOG.warning("grid_loss disabled: a class weight <= 0 would drop "
                    "that class from the in-kernel accuracy denominator; "
                    "keeping the pair-form step for consistent metrics")
        grid_loss = False

    def relation_train_step(state: TrainState, table: torch.Tensor,
                            batch: dict) -> dict:
        cw = (None if class_weights is None else
              torch.as_tensor(class_weights, dtype=torch.float32,
                              device=table.device))
        seeds = state.dropout_seeds(batch["tokens"].shape[0])
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = relation_loss(state.model, table, batch, seeds, cw,
                                      grid_loss)
        loss.backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    relation_train_step.grid_loss = grid_loss
    return relation_train_step


def relation_predict(model: RelationModel, table: torch.Tensor,
                     batch: dict) -> torch.Tensor:
    """Relation class probabilities [I, P, 4] (softmax over the logits)."""
    with torch.inference_mode():
        return torch.softmax(model(table, batch), dim=-1)
