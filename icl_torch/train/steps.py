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

On CUDA outside a process group the relation and affinity steps run as one
CUDA graph per batch key (:mod:`icl_torch.train.graphs`), the same loss,
backward and Adam replayed in one launch.

Data parallelism (a ``mesh`` given to a step maker, under a process group):
the loss is ``sum ce*w / max(sum w, 1)`` over the GLOBAL batch, and the
ranks hold different weight sums, so a mean of per-rank means would be
another number.  Each rank computes its local ``sum ce*w``, ``sum w``, hits
and valid count; those four are summed over the ranks first
(:func:`icl_torch.dist.mesh.all_reduce_sum`); the rank's loss is its local
``sum ce*w`` over the global ``max(sum w, 1)``; after ``backward`` the
gradients are summed over the ranks in one flat all-reduce; then Adam, the
same on every rank.  A rank whose rows are all padding takes part in both
collectives with zeros.  The metrics returned are the global ones, equal on
every rank.  The dropout seeds are the global batch's, cut to the rank's
rows.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from icl_torch.dist.mesh import Mesh, all_reduce_sum, local_data_rows
from icl_torch.util.log import LOG
from icl_torch.models.affinity import AffinityModel, rank_boxes
from icl_torch.models.nonvisual import MentionFFNN, mean_pool_tokens
from icl_torch.models.relation import RelationModel
from icl_torch.ops.affinity_rank import affinity_rank
from icl_torch.ops.ce import onehot_ce
from icl_torch.train import graphs
from icl_torch.train.state import TrainState
from icl_torch.util import trace


def masked_weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor,
                       class_weights: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Mean CE over valid entries, optionally weighted per class."""
    loss_sum, wsum = _ce_sums(logits, labels, valid, class_weights)
    return loss_sum / torch.clamp_min(wsum, 1.0)


def _ce_sums(logits, labels, valid, class_weights):
    """``(sum ce*w, sum w)`` of :func:`masked_weighted_ce`."""
    ce, onehot = onehot_ce(logits, labels)
    w = valid.to(ce.dtype)
    if class_weights is not None:
        w = w * (onehot * class_weights).sum(dim=-1)
    return (ce * w).sum(), w.sum()


def _accuracy(logits, labels, valid):
    hit = (logits.argmax(dim=-1) == labels) & valid
    return hit.sum() / torch.clamp_min(valid.sum(), 1)


def _finish(loss_sum, wsum, hits, nvalid, mesh: Mesh | None, extra=False):
    """``(loss, metrics)`` from a batch's four sums.  Under a mesh they are
    this rank's: the global sums come from one all-reduce, the loss that is
    differentiated is the rank's share ``local sum ce*w / max(global sum w,
    1)`` (its gradients add up to the global loss's over the ranks), and the
    metrics are the global ones."""
    if mesh is None:
        loss = loss_sum / torch.clamp_min(wsum, 1.0)
        metrics = {"loss": loss, "acc": hits / torch.clamp_min(nvalid, 1)}
    else:
        sums = torch.stack([loss_sum.detach(), wsum.detach()]
                           + [x.detach().to(loss_sum.dtype)
                              for x in (hits, nvalid)])
        all_reduce_sum([sums], mesh)
        g_loss, g_wsum, hits, nvalid = sums.unbind(0)
        loss = loss_sum / torch.clamp_min(g_wsum, 1.0)
        metrics = {"loss": g_loss / torch.clamp_min(g_wsum, 1.0),
                   "acc": hits / torch.clamp_min(nvalid, 1.0)}
    if extra:
        metrics.update(hits=hits, nvalid=nvalid)
    return loss, metrics


def _sync_gradients(state: TrainState, mesh: Mesh) -> None:
    """Sum the parameters' gradients over the ranks, in place, in one flat
    all-reduce; a parameter the rank's loss did not reach adds zeros."""
    grads = []
    for p in state.model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    all_reduce_sum(grads, mesh)


def _active(mesh: Mesh | None) -> Mesh | None:
    """The mesh when a process group is up (a world of one included: the
    sums then run over one rank), else None: the single-process step."""
    return mesh if mesh is not None and dist.is_initialized() else None


def _seeds(state: TrainState, local_rows: int, mesh: Mesh | None):
    """The rank's rows of the global batch's dropout seeds."""
    if mesh is None:
        return state.dropout_seeds(local_rows)
    n_global = local_rows * mesh.data
    return state.dropout_seeds(n_global, local_data_rows(mesh, n_global))


# ---------------------------------------------------------------------------
# Mention-level tasks (nonvisual, cardinality): flat [N, L] token batches
# ---------------------------------------------------------------------------

def mention_loss(model: MentionFFNN, table: torch.Tensor,
                 token_ids: torch.Tensor, lengths: torch.Tensor,
                 labels: torch.Tensor, valid: torch.Tensor,
                 seeds: torch.Tensor | None,
                 mesh: Mesh | None = None) -> tuple[torch.Tensor, dict]:
    """The mention train loss and its metrics, before any update:
    ``(loss, {"loss", "acc"})``.  ``seeds``: per-row dropout seeds (None: no
    dropout).  The table is an input: it gets no gradient.  ``mesh``: the
    batch is this rank's rows of a global one (the module docstring)."""
    pooled = mean_pool_tokens(table.detach(), token_ids, lengths)
    return _logit_loss(model(pooled, seeds=seeds), labels, valid, None, mesh)


def make_mention_train_step(mesh: Mesh | None = None) -> Callable:
    """``step(state, table, token_ids, lengths, labels, valid) -> metrics``
    for the FFNN-over-mean-word-vector tasks: one Adam update in place.
    After the step, the parameters' ``.grad`` hold the step's gradients.
    ``mesh``: the data-parallel step over this rank's rows."""

    def train_step(state: TrainState, table: torch.Tensor,
                   token_ids: torch.Tensor, lengths: torch.Tensor,
                   labels: torch.Tensor, valid: torch.Tensor) -> dict:
        dp = _active(mesh)
        seeds = _seeds(state, token_ids.shape[0], dp)
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = mention_loss(state.model, table, token_ids, lengths,
                                     labels, valid, seeds, dp)
        loss.backward()
        if dp is not None:
            _sync_gradients(state, dp)
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


def _grid_loss(model, table, batch, seeds, glabel, gvalid, class_weights,
               mesh=None):
    """The grid-loss form: the model's grid CE sums over the cells of
    weight ``gvalid * class_weight[label]`` -> (loss, metrics)."""
    gweight = _cell_weights(glabel, gvalid, class_weights)
    loss_sum, hits, nval = model(table, batch, seeds=seeds,
                                 loss_grid=(glabel, gweight))
    return _finish(loss_sum, gweight.sum(), hits, nval, mesh, extra=True)


def _logit_loss(logits, labels, valid, class_weights, mesh=None):
    loss_sum, wsum = _ce_sums(logits, labels, valid, class_weights)
    hit = (logits.argmax(dim=-1) == labels) & valid
    return _finish(loss_sum, wsum, hit.sum(), valid.sum(), mesh)


def relation_loss(model: RelationModel, table: torch.Tensor, batch: dict,
                  seeds: torch.Tensor | None,
                  class_weights: torch.Tensor | None = None,
                  grid_loss: bool = False,
                  mesh: Mesh | None = None) -> tuple[torch.Tensor, dict]:
    """The train loss and its metrics, before any update.

    Returns ``(loss, {"loss", "acc"})``; the grid-loss form adds ``hits``
    and ``nvalid``.  ``seeds``: per-image dropout seeds (None: no dropout).
    ``mesh``: the batch is this rank's rows of a global one (the module
    docstring).
    """
    if grid_loss:
        return _grid_loss(model, table, batch, seeds, *_grid_cells(batch),
                          class_weights, mesh)
    return _logit_loss(model(table, batch, seeds=seeds), batch["pair_label"],
                       batch["pair_valid"], class_weights, mesh)


def affinity_loss(model: AffinityModel, table: torch.Tensor, batch: dict,
                  seeds: torch.Tensor | None,
                  class_weights: torch.Tensor | None = None,
                  grid_loss: bool = False,
                  mesh: Mesh | None = None) -> tuple[torch.Tensor, dict]:
    """As :func:`relation_loss`, over the (mention, box) cells: the labels
    are grid-shaped already (``grid_label``/``grid_valid``), so the cell
    form is :func:`masked_weighted_ce` over the logit grid."""
    glabel, gvalid = batch["grid_label"].to(torch.int32), batch["grid_valid"]
    if grid_loss:
        return _grid_loss(model, table, batch, seeds, glabel, gvalid,
                          class_weights, mesh)
    return _logit_loss(model(table, batch, seeds=seeds), glabel, gvalid,
                       class_weights, mesh)


def _make_train_step(loss_fn, images_key: str, class_weights, grid_loss,
                     other_form: str, mesh: Mesh | None = None) -> Callable:
    """The image tasks' step.  On CUDA outside a process group it runs
    as one CUDA graph per batch key (:mod:`icl_torch.train.graphs`); else
    eagerly, with spans (:mod:`icl_torch.util.trace`) ``train.forward``
    (the loss), ``train.backward`` and ``train.optimizer`` (Adam).  Both
    lie in span ``train.step`` and count one ``train.step``."""
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

    def eager(state: TrainState, table: torch.Tensor, batch: dict,
              dp: Mesh | None = None, set_to_none: bool = True) -> dict:
        cw = class_weight_tensor(table.device)
        seeds = _seeds(state, batch[images_key].shape[0], dp)
        state.optimizer.zero_grad(set_to_none=set_to_none)
        with trace.span("train.forward"):
            loss, metrics = loss_fn(state.model, table, batch, seeds, cw,
                                    grid_loss, dp)
        with trace.span("train.backward"):
            loss.backward()
        if dp is not None:
            _sync_gradients(state, dp)
        with trace.span("train.optimizer"):
            state.apply_gradients()
        return {k: v.detach() for k, v in metrics.items()}

    graphed = graphs.GraphedStep(
        lambda state, table, batch: eager(state, table, batch,
                                          set_to_none=False),
        lambda state, table, batch, seeds: loss_fn(
            state.model, table, batch, seeds,
            class_weight_tensor(table.device), grid_loss),
        images_key)

    def train_step(state: TrainState, table: torch.Tensor,
                   batch: dict) -> dict:
        with trace.span("train.step"):
            trace.count("train.step")
            dp = _active(mesh)
            if dp is None and graphs.graphable(table):
                return graphed(state, table, batch)
            return eager(state, table, batch, dp)

    train_step.grid_loss = grid_loss
    train_step.class_weight_tensor = class_weight_tensor
    train_step.graphed = graphed
    return train_step


def make_relation_train_step(class_weights=None, grid_loss: bool = False,
                             mesh: Mesh | None = None) -> Callable:
    """``step(state, table, batch) -> metrics``: one Adam update in place.

    ``grid_loss=True`` (the fused production mode) computes the CE over the
    M x M grid.  Its accuracy counts cells of weight > 0, so a class weight
    <= 0 would drop that class from the accuracy's denominator; then the
    pair form is kept instead, so metric meanings never depend on the form.
    After the step, the parameters' ``.grad`` hold the step's gradients
    (under a ``mesh``: the global batch's, summed over the ranks).
    ``mesh``: the data-parallel step over this rank's rows of the batch.
    """
    return _make_train_step(relation_loss, "tokens", class_weights,
                            grid_loss, "pair", mesh)


def make_affinity_train_step(class_weights=None, grid_loss: bool = False,
                             mesh: Mesh | None = None) -> Callable:
    """As :func:`make_relation_train_step` for the affinity model; a class
    weight <= 0 keeps the cell form."""
    return _make_train_step(affinity_loss, "phrase_tokens", class_weights,
                            grid_loss, "cell", mesh)


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
    (:func:`icl_torch.ops.affinity_rank.affinity_rank`; in bf16 its
    fast-dot mode, over the logits the probabilities come from), a plain
    one with :func:`~icl_torch.models.affinity.rank_boxes` over its logits.
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
                                    model.head_out.bias, box_valid,
                                    fast_dot=model.fast_dot)
        else:
            ranking = rank_boxes(logits, box_valid)
        return probs, ranking
