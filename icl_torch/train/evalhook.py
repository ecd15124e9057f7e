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

More than one process (a ``mesh`` under a process group): eval batches are
rng-deterministic, so every rank builds the IDENTICAL host-side batch list,
places only its own data-axis rows of each batch (:func:`_eval_placer`) and
computes its rows' sums; the per-batch sums are all-reduced in one
collective before the one read, so every rank reads the SAME loss and the
loop's early-stop decision stays in lockstep.  The image tasks' weight sum
is computed host-side from the full (pre-slice) batch, so the normaliser is
global by construction.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from icl_torch.dist.mesh import (Mesh, all_reduce_sum, process_count,
                                 shard_batch, shard_batch_local)
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


def _eval_placer(mesh: Mesh | None, device: torch.device) -> Callable:
    """tree-of-host-arrays -> tensors on the device.  Single-process: the
    whole batch.  Multi-process: every rank holds the full batch
    (deterministic build) and places its own contiguous [lo, hi) data-axis
    rows of every array."""
    if mesh is None:
        return lambda tree: shard_batch_local(tree, mesh, device)
    return lambda tree: shard_batch(tree, mesh, device)


def _global_sums(sums: list, mesh: Mesh | None) -> list:
    """The per-batch ``[sum ce*w, hits, valid]`` rows summed over the ranks
    (one collective), read from the device once."""
    stacked = torch.stack(sums)
    if mesh is not None and process_count() > 1:
        all_reduce_sum([stacked], mesh)
    return stacked.cpu().tolist()


def make_grid_eval_fn(model, table: torch.Tensor, eval_batches: list,
                      class_weights=None, pin: bool = True,
                      mesh: Mesh | None = None) -> Callable:
    """Build ``eval_fn(state) -> {"loss", "acc"}`` over fixed batches.

    ``eval_batches``: list of HOST-side batch dicts (numpy; under bf16
    affinity box features are a host tensor of the batcher's ``box_dtype``)
    that carry ``grid_label``/``grid_valid`` (RelationBatcher with
    ``build_grid=True``, or any AffinityBatcher batch).  The list is built
    ONCE (seeded shuffle in :func:`build_eval_hook`, then frozen), so
    successive evals are comparable point-to-point.

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
    place = _eval_placer(mesh, table.device)
    prepared = []
    for hb in eval_batches:
        weights = _host_cell_weights(hb["grid_label"], hb["grid_valid"],
                                     class_weights)
        # weight sum from the FULL host batch: the global normaliser, even
        # when this process only feeds a row slice below
        wsum = float(weights.sum())
        tree = {"b": hb, "w": weights}
        if degenerate:
            tree["u"] = _host_cell_weights(hb["grid_label"],
                                           hb["grid_valid"], None)
        prepared.append((place(tree) if pin else tree, wsum))

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
                    dev = tree if pin else place(tree)
                    jb, weights, uniform = dev["b"], dev["w"], dev.get("u")
                    ls, h, nv = one(state, jb, weights)
                    if uniform is not None:
                        _, h, nv = one(state, jb, uniform)
                    sums.append(torch.stack([ls, h, nv]))
                    wsum += w
                # one device-to-host read for the whole eval
                for ls, h, nv in _global_sums(sums, mesh):
                    loss_sum += ls
                    hits += h
                    nval += nv
        finally:
            state.model.train(was_training)
        return {"loss": loss_sum / max(wsum, 1.0),
                "acc": hits / max(nval, 1.0)}

    return eval_fn


def build_eval_hook(args, model, table: torch.Tensor, load_dataset, batcher,
                    class_weights=None,
                    mesh: Mesh | None = None) -> Callable | None:
    """CLI glue: resolve --eval_every/--eval_split into an eval_fn.

    Returns None (with a log line explaining why) when eval is off or the
    split is missing.  Multi-process runs are supported: every process
    builds the identical batch list (deterministic rng) and feeds its own
    data-axis slice (module docstring)."""
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
        batches.append(dict(b.arrays))
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
                             pin=not full, mesh=mesh)


def make_mention_eval_fn(model, table: torch.Tensor, eval_batches: list,
                         pin: bool = True,
                         mesh: Mesh | None = None) -> Callable:
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

    place = _eval_placer(mesh, table.device)
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
                for ls, h, nv in _global_sums(sums, mesh):
                    loss_sum += ls
                    hits += h
                    nval += nv
        finally:
            state.model.train(was_training)
        return {"loss": loss_sum / max(nval, 1.0),
                "acc": hits / max(nval, 1.0)}

    return eval_fn


def build_mention_eval_hook(args, model, table: torch.Tensor, task: str, emb,
                            bucketizer,
                            mesh: Mesh | None = None) -> Callable | None:
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
    return make_mention_eval_fn(model, table, batches, pin=not full,
                                mesh=mesh)
