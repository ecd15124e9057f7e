"""In-training dev evaluation hooks (counterpart of
``icl/train/evalhook.py``).

A deterministic ``eval_fn`` handed to :func:`icl_torch.train.loop.
run_training`.  The image tasks evaluate in the grid-loss form without
dropout: the
model returns ``(sum ce*w, sum hits, sum valid)`` per batch (the plain
``grid_ce_sums`` on an unfused model, the fused-CE kernel at rate 0 on a
fused one) and the hook normalises across the whole eval set, so the
reported loss is exactly ``masked_weighted_ce`` over every sampled dev
cell, not a mean of per-batch means.  It runs under
``torch.inference_mode()``: no graph is built and the forward-only kernels
are allowed.  The mention tasks (:func:`make_mention_eval_fn`) sum ``ce*w``,
hits and ``w`` over the whole eval set the same way.  Each eval reads the
device once.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from icl_torch.ops.ce import onehot_ce
from icl_torch.util.log import LOG


def _host_cell_weights(labels, valid, class_weights) -> np.ndarray:
    """Host-numpy mirror of icl_torch.train.steps._cell_weights (the same
    per-class selection, so the float32 values are bitwise identical)."""
    w = np.asarray(valid).astype(np.float32)
    if class_weights is None:
        return w
    cw = np.asarray(class_weights, np.float32)
    sel = np.zeros(np.shape(labels), np.float32)
    labels = np.asarray(labels)
    for k in range(cw.shape[0]):
        sel[labels == k] = cw[k]
    return w * sel


def _place(tree: dict, device: torch.device) -> dict:
    """Host arrays (nested one level) as tensors on ``device``."""
    return {k: (_place(v, device) if isinstance(v, dict)
                else torch.from_numpy(np.ascontiguousarray(v)).to(device))
            for k, v in tree.items()}


def make_grid_eval_fn(model, table: torch.Tensor, eval_batches: list,
                      class_weights=None, pin: bool = True) -> Callable:
    """Build ``eval_fn(state) -> {"loss", "acc"}`` over fixed batches.

    ``eval_batches``: list of HOST-side batch dicts (numpy) that carry
    ``grid_label``/``grid_valid`` (RelationBatcher with ``build_grid=True``,
    or any AffinityBatcher batch).  The list is built ONCE (seeded shuffle
    in :func:`build_eval_hook`, then frozen), so successive evals are
    comparable point-to-point.

    ``pin=True`` copies every batch to the table's device once and holds it
    for the whole run (device memory = the whole sample; the hook log prints
    the MB).  ``pin=False`` copies each batch per eval call instead (one
    batch resident at a time): the ``--eval_batches 0`` whole-split mode.
    Both modes run the same reduction on the same values, so their losses
    are bitwise equal.
    """
    # A class weight <= 0 makes grid-form metrics degenerate (validity is
    # weight > 0, so that class would drop out of the accuracy denominator).
    # The train step keeps the weights and falls back to the pair-form loss;
    # eval mirrors that weighting, so eval_loss stays comparable to the
    # train loss, and recovers the all-valid-cells accuracy from a second,
    # uniform-weight pass.
    degenerate = (class_weights is not None
                  and any(w <= 0 for w in class_weights))
    if degenerate:
        LOG.warning("eval hook: class weight <= 0 — eval_loss keeps the "
                    "train weighting; accuracy is computed from a second "
                    "uniform-weight pass so every valid cell counts")
    device = table.device
    prepared = []
    for hb in eval_batches:
        weights = _host_cell_weights(hb["grid_label"], hb["grid_valid"],
                                     class_weights)
        wsum = float(weights.sum())     # the global normaliser's share
        tree = {"b": hb, "w": weights}
        if degenerate:
            tree["u"] = _host_cell_weights(hb["grid_label"],
                                           hb["grid_valid"], None)
        prepared.append((_place(tree, device) if pin else tree, wsum))

    def one(state, jb, weights):
        return state.model(table, jb, loss_grid=(
            jb["grid_label"].to(torch.int32), weights))

    def eval_fn(state):
        loss_sum = hits = nval = 0.0
        wsum = 0.0
        was_training = state.model.training
        state.model.eval()
        try:
            with torch.inference_mode():
                sums = []
                for tree, w in prepared:
                    dev = tree if pin else _place(tree, device)
                    jb, weights, uniform = dev["b"], dev["w"], dev.get("u")
                    ls, h, nv = one(state, jb, weights)
                    if uniform is not None:
                        _, h, nv = one(state, jb, uniform)
                    sums.append(torch.stack([ls, h, nv]))
                    wsum += w
                # one device-to-host read for the whole eval
                for ls, h, nv in torch.stack(sums).cpu().tolist():
                    loss_sum += ls
                    hits += h
                    nval += nv
        finally:
            state.model.train(was_training)
        return {"loss": loss_sum / max(wsum, 1.0),
                "acc": hits / max(nval, 1.0)}

    return eval_fn


def build_eval_hook(args, model, table: torch.Tensor, load_dataset, batcher,
                    class_weights=None) -> Callable | None:
    """CLI glue: resolve --eval_every/--eval_split into an eval_fn.

    Returns None (with a log line explaining why) when eval is off or the
    split is missing."""
    if not getattr(args, "eval_every", 0):
        return None
    try:
        ds = load_dataset(args.data_dir, args.eval_split)
    except FileNotFoundError as e:
        LOG.warning("--eval_every ignored: eval split %r not loadable (%s)",
                    args.eval_split, e)
        return None
    cap_arg = getattr(args, "eval_batches", 16)
    full = cap_arg == 0          # 0 = the WHOLE split, copied per eval
    cap = None if full else max(cap_arg, 1)
    batches = []
    # seeded shuffle: the batchers schedule bucket-by-bucket, so taking the
    # FIRST cap batches unshuffled would evaluate only the smallest-bucket
    # (shortest/easiest) images; a fixed seed keeps evals comparable
    # point-to-point across the run
    rng = np.random.default_rng(getattr(args, "seed", 0))
    for b in batcher.batches(ds, rng=rng):
        batches.append({k: np.asarray(v) for k, v in b.arrays.items()})
        if cap is not None and len(batches) >= cap:
            break
    if not batches:
        LOG.warning("--eval_every ignored: eval split %r is empty",
                    args.eval_split)
        return None
    n = int(sum(b["img_valid"].sum() for b in batches))
    mb = sum(sum(v.nbytes for v in b.values()) for b in batches) / 2**20
    LOG.info("eval hook: %d batches (%d images, %.0f MB %s) "
             "from %s every %d steps",
             len(batches), n, mb,
             "copied to the device per eval" if full else
             "held on the device",
             args.eval_split, args.eval_every)
    return make_grid_eval_fn(model, table, batches, class_weights,
                             pin=not full)


def make_mention_eval_fn(model, table: torch.Tensor, eval_batches: list,
                         pin: bool = True) -> Callable:
    """Mention-task (nonvisual, cardinality) counterpart of
    :func:`make_grid_eval_fn`.

    ``eval_batches``: list of HOST-side ``(token_ids, lengths, labels,
    valid)`` numpy tuples.  Forward without dropout, the shared CE,
    normalised across the whole eval set.  ``pin`` as in
    :func:`make_grid_eval_fn`: batches held on the table's device, or copied
    per eval call (the ``--eval_batches 0`` whole-split mode); both give
    bitwise equal results.
    """
    from icl_torch.models.nonvisual import mean_pool_tokens

    device = table.device

    def place(hb):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in hb)

    prepared = [place(hb) if pin else hb for hb in eval_batches]

    def one(state, tok, ln, lab, valid):
        logits = state.model(mean_pool_tokens(table, tok, ln))
        ce, _ = onehot_ce(logits, lab)
        w = valid.to(ce.dtype)
        hits = (logits.argmax(dim=-1) == lab) & valid
        return torch.stack([(ce * w).sum(), hits.to(torch.float32).sum(),
                            w.sum()])

    def eval_fn(state):
        loss_sum = hits = nval = 0.0
        was_training = state.model.training
        state.model.eval()
        try:
            with torch.inference_mode():
                sums = [one(state, *(hb if pin else place(hb)))
                        for hb in prepared]
                # one device-to-host read for the whole eval
                for ls, h, nv in torch.stack(sums).cpu().tolist():
                    loss_sum += ls
                    hits += h
                    nval += nv
        finally:
            state.model.train(was_training)
        return {"loss": loss_sum / max(nval, 1.0),
                "acc": hits / max(nval, 1.0)}

    return eval_fn


def build_mention_eval_hook(args, model, table: torch.Tensor, task: str, emb,
                            bucketizer) -> Callable | None:
    """CLI glue for the mention tasks (mirrors :func:`build_eval_hook`)."""
    if not getattr(args, "eval_every", 0):
        return None
    from icl_torch.data.pipeline import load_mention_dataset
    try:
        ds = load_mention_dataset(args.data_dir, args.eval_split, task, emb)
    except FileNotFoundError as e:
        LOG.warning("--eval_every ignored: eval split %r not loadable (%s)",
                    args.eval_split, e)
        return None
    cap_arg = getattr(args, "eval_batches", 16)
    full = cap_arg == 0          # 0 = the WHOLE split, copied per eval
    cap = None if full else max(cap_arg, 1)
    arrays = {"token_ids": ds.token_ids, "lengths": ds.lengths,
              "labels": ds.labels}
    rng = np.random.default_rng(getattr(args, "seed", 0))
    batches = []
    for _, b in bucketizer.batches(ds.lengths, arrays, ds.ids,
                                   shuffle_rng=rng):
        batches.append((np.asarray(b.arrays["token_ids"]),
                        np.asarray(b.arrays["lengths"]),
                        np.asarray(b.arrays["labels"]),
                        np.asarray(b.valid)))
        if cap is not None and len(batches) >= cap:
            break
    if not batches:
        LOG.warning("--eval_every ignored: eval split %r is empty",
                    args.eval_split)
        return None
    n = int(sum(v.sum() for *_, v in batches))
    LOG.info("eval hook: %d batches (%d mentions, %s) from %s every "
             "%d steps", len(batches), n,
             "copied to the device per eval" if full else
             "held on the device",
             args.eval_split, args.eval_every)
    return make_mention_eval_fn(model, table, batches, pin=not full)
