"""The window over ranked affinity predict, as ``--predict --rank_file``
composes it.

The split is made from the seed and swept again and again: the program's
``AffinityBatcher`` (ids on) under its ``prefetch`` thread, ``to_device``,
``affinity_predict(rank=True)`` with at most ``in_flight`` calls queued on
the device, then one host copy a batch and one fancy-index gather of the
valid cells, kept per id as the command keeps them.  The cell's file states
the precision and the compute dtype (``compute_dtype``, ``f32`` or
``bf16``; the box block is assembled in ``box_dtype``, by default the
compute dtype, as the command does).  Set-up ends after one whole sweep
(every bucket shape the split has, every kernel built); the window then
counts the cells that reached the host.

Correctness: ``checked_batches`` positions of the sweep, drawn from the
seed and always with the batch of most cells, keep every copy the window
produced; after the window the plain reference scores the images of those
batches from the generated inputs, and every kept answer is held to it.
An answer due in the window that never came counts as missing.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time

import numpy as np
import torch

from portbench.lib import program, synth
from portbench.lib.trace import Traced, span
from portbench.lib.weights import make_params, make_table

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _parse_id(cid: str) -> tuple:
    """A cell id's (image id, caption, mention, box) by the ids' grammar."""
    f = dict(kv.split(":", 1) for kv in cid.split(";"))
    return f["doc"], int(f["caption"]), int(f["mention"]), int(f["box"])


def _within(mentions: list) -> list[int]:
    """Each mention's index within its caption (mentions in caption
    order)."""
    out = []
    for r, (c, _, _) in enumerate(mentions):
        out.append(out[-1] + 1 if r and mentions[r - 1][0] == c else 0)
    return out


def _reference(ref, params, table, images, boxes, ids: list[str]) -> dict:
    """The plain reference's (probabilities, ranking) for every id of
    ``ids``, as one row [p0, p1, rank]."""
    keys = [_parse_id(cid) for cid in ids]
    by_id = {im["img_id"]: im for im in images}
    imgs = [by_id[n] for n in sorted({k[0] for k in keys})]
    out = {}
    got = ref.predict(params, table, imgs, boxes)
    for im, (probs, rank) in zip(imgs, got):
        w = _within(im["mentions"])
        for r, (c, _, _) in enumerate(im["mentions"]):
            for bi in range(im["n_boxes"]):
                out[(im["img_id"], c, w[r], bi)] = np.append(
                    probs[r, bi], rank[r, bi])
    return {cid: out.get(k) for cid, k in zip(ids, keys)}


def run(ctx: dict) -> dict:
    from icl_torch.cli._common import to_device
    from icl_torch.data.buckets import BucketSpec
    from icl_torch.data.imagebatch import AffinityBatcher
    from icl_torch.models.affinity import AffinityModel
    from icl_torch.train import steps
    from icl_torch.train.loop import prefetch

    cell, seed, device = ctx["cell"], ctx["seed"], ctx["device"]
    spec, traffic, cfg = cell["spec"], cell["traffic"], cell["config"]
    prec = program.set_precision(spec["precision"], device, predict=True,
                                 tf32=True if ctx.get("control") else None)
    cd = DTYPES[spec.get("compute_dtype", "f32")]
    box_dtype = DTYPES[spec.get("box_dtype", spec.get("compute_dtype",
                                                      "f32"))]
    images = synth.affinity_images(cfg, traffic["images"], seed)
    boxes = synth.box_block(sum(im["n_boxes"] for im in images),
                            cfg["box_dim"], seed, device)
    ds = program.affinity_dataset(images, boxes, cfg["phrase_len"])
    params = make_params(cfg, seed, device)
    table = make_table(cfg, seed, device).to(cd)
    buckets = BucketSpec((8, 16, 32))
    batcher = AffinityBatcher(
        images_per_batch=traffic["images_per_batch"], mention_spec=buckets,
        box_spec=buckets, phrase_len=cfg["phrase_len"], box_dtype=box_dtype,
        with_ids=True)
    model = AffinityModel(
        emb_dim=cfg["emb_dim"], box_dim=cfg["box_dim"],
        lstm_hidden=cfg["lstm_hidden"], head_hidden=cfg["head_hidden"],
        num_classes=cfg["num_classes"], fused=True, device=device,
        compute_dtype=cd, exact=prec.head_exact)
    model.load_flat(params)
    model.eval()
    depth, in_flight = traffic["prefetch_depth"], traffic["in_flight"]
    work = ctx["work"]
    units: dict[int, int] = {}          # cells at each position
    kept: dict[int, list] = {}          # the checked positions' answers

    def predict(jb):
        probs, rank = steps.affinity_predict(model, table, jb, rank=True)
        return torch.cat([probs, rank[..., None]], dim=-1)

    def gather(b, dev_out):
        """One host copy, one fancy-index gather: [n, 3] probabilities
        and ranking."""
        out = dev_out.float().cpu().numpy()
        B = out.shape[2]
        idx = np.asarray([(s, *divmod(c, B)) for s, c, _ in b.id_index],
                         np.int64).reshape(-1, 3)
        return out[idx[:, 0], idx[:, 1], idx[:, 2]]

    def batches():
        for s in itertools.count():
            for p, b in enumerate(batcher.batches(ds)):
                yield s, p, b

    feed = prefetch(batches(), depth=depth)
    by_id: dict = {}
    pending: collections.deque = collections.deque()
    tally = {"units": 0, "batches": 0, "wait_s": 0.0, "stats": [],
             "attempted": 0}

    def consume(record: bool):
        (s, p, b), dev_out = pending.popleft()
        with span("consume"):
            sel = gather(b, dev_out)
            for k, (_, _, cid) in enumerate(b.id_index):
                by_id[cid] = sel[k]
        if record:
            tally["units"] += len(b.id_index)
            if p in kept:
                kept[p].append(([cid for _, _, cid in b.id_index], sel))

    def step(record: bool):
        t0 = time.perf_counter()
        with span("wait_batch"):
            s, p, b = next(feed)
        units[p] = len(b.id_index)
        if record:
            tally["wait_s"] += time.perf_counter() - t0
            tally["batches"] += 1
            tally["attempted"] += len(b.id_index)
            if ctx["trace"]:
                tally["stats"].append(work.stats(b.arrays, cfg))
        with span("to_device"):
            jb = to_device(b.arrays, device)
        with span("predict"):
            pending.append(((s, p, b), predict(jb)))
        if len(pending) > in_flight:
            consume(record)
        return s

    # set-up: one whole sweep through the window's own loop
    while step(False) == 0:
        pass
    while pending:
        consume(False)
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, seed >> 32 & 0xFFFFFFFF, 7]))
    longest = max(units, key=units.get)
    others = sorted(p for p in units if p != longest)
    n_check = min(traffic["checked_batches"] - 1, len(others))
    for p in [longest, *rng.choice(others, n_check, replace=False).tolist()]:
        kept[int(p)] = []
    program.sync(device)
    seconds = (min(ctx["seconds"], spec["trace_seconds"]) if ctx["trace"]
               else ctx["seconds"])
    traced = Traced(device) if ctx["trace"] else None
    with traced or contextlib.nullcontext():
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            step(True)
        while pending:
            consume(True)
        program.sync(device)
    window = time.perf_counter() - t_start
    feed.close()
    peak = program.memory_peak(device)
    del pending, by_id, model
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # the check: every kept answer against the plain reference
    O = cfg["num_classes"]
    gaps = {"probs_gap": 0.0, "rank_gap": 0.0}
    missing = 0
    ref_table = make_table(cfg, seed, device)
    for p, copies in kept.items():
        if not copies:
            missing += 1
            continue
        want = _reference(ctx["reference"], params, ref_table, images,
                          boxes, copies[0][0])
        for ids, sel in copies:
            for k, cid in enumerate(ids):
                w = want[cid]
                if w is None:
                    missing += 1
                    continue
                gaps["probs_gap"] = max(gaps["probs_gap"], float(
                    np.abs(sel[k][:O] - w[:O]).max()))
                gaps["rank_gap"] = max(gaps["rank_gap"],
                                       float(abs(sel[k][O] - w[O])))
    checks = {**gaps, "missing": float(missing)}
    return {"window_s": window, "t_start": t_start, "memory_peak": peak,
            "e2e": {"cells_per_s": tally["units"] / window},
            "attempted": tally["attempted"], "failed": 0,
            "checks": checks, "trace": traced.trace if traced else None,
            "stats": {**tally, "cfg": cfg,
                      "assembly_wait_ms": tally["wait_s"] * 1e3
                      / max(tally["batches"], 1)}}
