"""The window over joint inference, as ``icl-torch-joint --predict
--with_cardinality --with_rank`` composes it.

One split is made from the seed: images whose captions, mentions, mention
pairs, phrases (the mentions' spans) and boxes all four tasks read.  The
four models lie on the device at once, over one word-vector table.  A pass
is the four sweeps in the joint command's order (nonvisual, relation,
affinity with the box ranking, cardinality), each built by its CLI's
``predict_parts`` and run by ``icl_torch.cli._predict.predict_in_order``
(the prefetch worker, 3 predicts in flight, one host read a batch), each
result written by ``_predict.write_scores`` and the ranking by
``icl_torch.cli.affinity.write_rank``, into a temporary directory.  The
batchers are the joint command's: 8 images a batch (``images_per_batch``),
the CLIs' buckets, 512 mentions a batch (``batch_size``).  Set-up ends after
one whole pass; the window runs whole passes until ``--seconds`` have
elapsed and finishes the pass in progress.  ``cells_per_s`` counts the
affinity cells of the window's passes, each delivered with its image's
whole ILP input set.

Correctness, of what the window's last pass produced: the plain reference
scores the images of the last ``checked_batches`` batches of each image
sweep and the mentions of those images, and each task's rows, as its sweep
returned them, are held to it (``relation_probs_gap``,
``affinity_probs_gap``, ``rank_gap``, ``mention_probs_gap``); the checked
rows read back from the written files must equal those rows at the
format's 6 decimals, ids included (``scores_mismatch``); and a row due in a
pass that never reached the host counts as ``missing``.
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
import tempfile
import time
import types

import numpy as np
import torch

from portbench.lib import program, synth
from portbench.lib.trace import Traced
from portbench.lib.weights import make_params, make_table

TASKS = ("nonvisual", "relation", "affinity", "cardinality")
UNITS = {"nonvisual": "mentions", "relation": "pairs", "affinity": "cells",
         "cardinality": "mentions"}
MENTION_TASKS = ("nonvisual", "cardinality")


def _rng(seed: int, *salt: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([seed & 0xFFFFFFFF,
                                   (seed >> 32) & 0xFFFFFFFF, 26, *salt])


def split(cfg: dict, n_images: int, seed: int) -> list[dict]:
    """The split's images: ``synth.affinity_images`` (captions, mentions,
    phrases, boxes) with every mention pair i < j and its label drawn from
    ``class_prior``, as ``synth.relation_images`` draws them."""
    images = synth.affinity_images(cfg, n_images, seed)
    rng = np.random.default_rng(_rng(seed, 1))
    prior = np.asarray(cfg["class_prior"], np.float64)
    for im in images:
        ii, jj = np.triu_indices(len(im["mentions"]), k=1)
        im["pairs"] = np.stack([ii, jj], 1).astype(np.int32)
        im["labels"] = rng.choice(len(prior), size=len(ii),
                                  p=prior / prior.sum()).astype(np.int32)
    return images


def model_cfg(cfg: dict, task: str) -> dict:
    """One model's widths, under the keys ``lib/weights.py`` reads."""
    if task in MENTION_TASKS:
        return {"emb_dim": cfg["emb_dim"], "hidden": cfg["mention_hidden"],
                "num_classes": cfg[f"{task}_classes"]}
    return {"model": task, "emb_dim": cfg["emb_dim"],
            "lstm_hidden": cfg["lstm_hidden"],
            "head_hidden": cfg[f"{task}_head_hidden"],
            "num_classes": cfg[f"{task}_classes"], "box_dim": cfg["box_dim"]}


def _ffnn_params(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """A mention FFNN's weights (``dense_1``, ``dense_out``) from one
    normal draw: lecun scales, small biases, as ``lib/weights.py``."""
    D, H, C = m["emb_dim"], m["hidden"], m["num_classes"]
    specs = {"dense_1/kernel": ((D, H), math.sqrt(1.0 / D)),
             "dense_1/bias": ((H,), 0.05),
             "dense_out/kernel": ((H, C), math.sqrt(1.0 / H)),
             "dense_out/bias": ((C,), 0.05)}
    sizes = [math.prod(s) for s, _ in specs.values()]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    return {k: (part.reshape(shape) * std).contiguous()
            for (k, (shape, std)), part in zip(specs.items(),
                                               flat.split(sizes))}


def weights(cfg: dict, seed: int, device) -> dict[str, dict]:
    """Each task's weights, f32 on ``device``, each from its own stream."""
    out = {}
    for k, task in enumerate(TASKS):
        s = int(_rng(seed, 2, k).generate_state(1, np.uint64)[0] >> 2)
        m = model_cfg(cfg, task)
        out[task] = (_ffnn_params(m, s, device) if task in MENTION_TASKS
                     else make_params(m, s, device))
    return out


def datasets(cfg: dict, images: list[dict], boxes: np.ndarray) -> dict:
    """The split as each task's dataset of the program (the two mention
    tasks read the same mentions)."""
    from icl_torch.data.pipeline import MentionDataset

    ids, rows = [], []
    for im in images:
        within: dict[int, int] = {}
        for (c, _, _), ph in zip(im["mentions"], im["phrases"]):
            within[c] = within.get(c, -1) + 1
            ids.append(f"doc:{im['img_id']};caption:{c};mention:{within[c]}")
            rows.append(ph[:cfg["mention_len"]])
    tokens = np.zeros((len(rows), cfg["mention_len"]), np.int32)
    for r, t in enumerate(rows):
        tokens[r, :len(t)] = t
    mentions = MentionDataset(tokens,
                              np.asarray([len(t) for t in rows], np.int32),
                              np.zeros(len(rows), np.int32), ids)
    return {"relation": program.relation_dataset(images),
            "affinity": program.affinity_dataset(images, boxes,
                                                 cfg["phrase_len"]),
            "nonvisual": mentions, "cardinality": mentions}


def build(cfg: dict, traffic: dict, params: dict, data: dict, table,
          device, prec) -> dict:
    """The four models with ``params`` loaded, in eval mode, computing in
    f32, and the joint command's batchers."""
    from icl_torch.data.buckets import Bucketizer, BucketSpec
    from icl_torch.data.imagebatch import AffinityBatcher, RelationBatcher
    from icl_torch.models.affinity import AffinityModel
    from icl_torch.models.cardinality import CardinalityModel
    from icl_torch.models.nonvisual import NonvisualModel
    from icl_torch.models.relation import RelationModel

    cd, ipb = torch.float32, traffic["images_per_batch"]
    rel, aff = model_cfg(cfg, "relation"), model_cfg(cfg, "affinity")
    models = {
        "relation": RelationModel(
            emb_dim=rel["emb_dim"], lstm_hidden=rel["lstm_hidden"],
            head_hidden=rel["head_hidden"], num_classes=rel["num_classes"],
            fused=True, device=device, compute_dtype=cd,
            exact=prec.head_exact),
        "affinity": AffinityModel(
            emb_dim=aff["emb_dim"], box_dim=aff["box_dim"],
            lstm_hidden=aff["lstm_hidden"], head_hidden=aff["head_hidden"],
            num_classes=aff["num_classes"], fused=True, device=device,
            compute_dtype=cd, exact=prec.head_exact)}
    for task, cls in (("nonvisual", NonvisualModel),
                      ("cardinality", CardinalityModel)):
        m = model_cfg(cfg, task)
        models[task] = cls(emb_dim=m["emb_dim"], hidden=m["hidden"],
                           num_classes=m["num_classes"], device=device)
    for task, model in models.items():
        model.load_flat(params[task])
        model.eval()
    return {"models": models, "table": table, "data": data,
            "relation": RelationBatcher(images_per_batch=ipb,
                                        build_grid=False, with_ids=True),
            "affinity": AffinityBatcher(images_per_batch=ipb, box_dtype=cd,
                                        with_ids=True),
            "mentions": {t: Bucketizer(BucketSpec((data[t].max_len,)),
                                       batch_size=traffic["batch_size"])
                         for t in MENTION_TASKS}}


def one_pass(job: dict, device, args, watch=None) -> dict:
    """The four sweeps and their writes, in ``icl-torch-joint``'s order,
    into ``args.data_dir``; returns each task's ``(ids, rows)`` in dataset
    order.  ``watch(task, where)`` may wrap each sweep's ``where``."""
    from icl_torch.cli import _mention_task, affinity, relation
    from icl_torch.cli._predict import predict_in_order, write_scores
    from icl_torch.data.pairs import RELATION_CLASSES
    from icl_torch.models.affinity import AFFINITY_CLASSES
    from icl_torch.models.cardinality import CARDINALITY_CLASSES
    from icl_torch.models.nonvisual import NONVIS_CLASSES

    classes = {"nonvisual": NONVIS_CLASSES, "relation": RELATION_CLASSES,
               "affinity": AFFINITY_CLASSES,
               "cardinality": CARDINALITY_CLASSES}
    table, data, out = job["table"], job["data"], {}
    for task in TASKS:
        model = job["models"][task]
        if task == "relation":
            parts = relation.predict_parts(model, table, data["relation"],
                                           job["relation"])
        elif task == "affinity":
            parts = affinity.predict_parts(model, table, data["affinity"],
                                           job["affinity"], True)
        else:
            parts = _mention_task.predict_parts(model, table, data[task],
                                                job["mentions"][task])
        batches, predict, where, ids = parts
        if watch is not None:
            where = watch(task, where)
        C = len(classes[task])
        rows = predict_in_order(batches, device, predict, where, ids,
                                UNITS[task], C + (task == "affinity"), task)
        write_scores(args, task, classes[task], ids, rows[:, :C], len(ids),
                     0)
        if task == "affinity":
            affinity.write_rank(
                os.path.join(args.data_dir,
                             f"{args.data_split}.affinity.rank"),
                args.data_split, ids, rows[:, C:], len(ids), model.fused)
        out[task] = (ids, rows)
    return out


def scores_paths(args) -> dict:
    """The files a pass writes, by what they hold."""
    d, s = args.data_dir, args.data_split
    out = {t: os.path.join(d, f"{s}.{t}.scores") for t in TASKS}
    out["rank"] = os.path.join(d, f"{s}.affinity.rank")
    return out


def _doc(eid: str) -> str:
    """The image id of an example id (``doc:<image>;...``)."""
    return eid[4:eid.index(";")]


def _offsets(counts) -> dict:
    """Each image's first row in dataset order, from (image, rows)."""
    out, k = {}, 0
    for name, n in counts:
        out[name] = (k, n)
        k += n
    return out


def _mismatch(path: str, ids, rows, picks) -> int:
    """Checked rows of a written file whose id or 6-decimal fields differ
    from ``ids``/``rows``, plus the difference in line counts."""
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    bad = abs(len(lines) - len(ids))
    for k in picks:
        want = ids[k] + "," + ",".join(f"{float(v):.6f}" for v in rows[k])
        if k >= len(lines) or lines[k] != want:
            bad += 1
    return bad


def check(ref, cfg, job, params, images, boxes, last, out, paths) -> dict:
    """The last pass against the plain reference and its written files."""
    by_id = {im["img_id"]: im for im in images}
    docs = {t: sorted({_doc(e) for ids in last[t] for e in ids})
            for t in last}
    gaps = dict.fromkeys(("relation_probs_gap", "affinity_probs_gap",
                          "rank_gap", "mention_probs_gap"), 0.0)
    mismatch = 0
    table = job["table"].float()

    def held(name, got, want):
        gaps[name] = max(gaps[name], float(np.abs(
            np.asarray(got, np.float64) - want).max(initial=0.0)))

    rel_at = _offsets((im["img_id"], len(im["pairs"])) for im in images)
    imgs = [by_id[d] for d in docs["relation"]]
    picks = {t: [] for t in (*TASKS, "rank")}
    for im, want in zip(imgs, ref.relation(params["relation"], table,
                                           imgs)):
        k, n = rel_at[im["img_id"]]
        held("relation_probs_gap", out["relation"][1][k:k + n], want)
        picks["relation"] += range(k, k + n)
    aff_at = _offsets((im["img_id"], len(im["phrases"]) * im["n_boxes"])
                      for im in images)
    imgs = [by_id[d] for d in docs["affinity"]]
    for im, (probs, rank) in zip(imgs, ref.affinity(
            params["affinity"], table, imgs, boxes)):
        k, n = aff_at[im["img_id"]]
        rows = out["affinity"][1][k:k + n]
        held("affinity_probs_gap", rows[:, :2], probs.reshape(n, -1))
        held("rank_gap", rows[:, 2], rank.reshape(n))
        picks["affinity"] += range(k, k + n)
    men_at = _offsets((im["img_id"], len(im["phrases"])) for im in images)
    imgs = [by_id[d] for d in sorted(set(docs["relation"])
                                     | set(docs["affinity"]))]
    phrases = [ph for im in imgs for ph in im["phrases"]]
    sel = []
    for im in imgs:
        k, n = men_at[im["img_id"]]
        sel += range(k, k + n)
    for task in MENTION_TASKS:
        if phrases:
            held("mention_probs_gap", out[task][1][sel],
                 ref.mention(params[task], table, phrases))
        picks[task] = sel
    picks["rank"] = picks["affinity"]
    for what, path in paths.items():
        ids, rows = out["affinity" if what == "rank" else what]
        C = rows.shape[1] - (what in ("affinity", "rank"))
        cols = rows[:, C:] if what == "rank" else rows[:, :C]
        mismatch += _mismatch(path, ids, cols, picks[what])
    return {**gaps, "scores_mismatch": float(mismatch)}


def run(ctx: dict) -> dict:
    # the program's entries first: a tree without them fails here, at once
    from icl_torch.cli import _mention_task, affinity, relation

    (relation.predict_parts, affinity.predict_parts, affinity.write_rank,
     _mention_task.predict_parts)

    cell, seed, device = ctx["cell"], ctx["seed"], ctx["device"]
    spec, traffic, cfg = cell["spec"], cell["traffic"], cell["config"]
    work = ctx["work"]
    prec = program.set_precision(spec["precision"], device, predict=True,
                                 tf32=True if ctx.get("control") else None)
    images = split(cfg, traffic["images"], seed)
    boxes = synth.box_block(sum(im["n_boxes"] for im in images),
                            cfg["box_dim"], seed, device)
    data = datasets(cfg, images, boxes)
    params = weights(cfg, seed, device)
    job = build(cfg, traffic, params, data, make_table(cfg, seed, device),
                device, prec)
    due = {"relation": data["relation"].num_pairs,
           "affinity": data["affinity"].num_cells,
           **{t: len(data[t].ids) for t in MENTION_TASKS}}
    got: collections.Counter = collections.Counter()
    last = {t: collections.deque(maxlen=traffic["checked_batches"])
            for t in ("relation", "affinity")}
    tally = {"batches": 0, "stats": [], "passes": 0, "missing": 0,
             "record": False}

    def watch(task, where):
        def counted(b):
            lead, ids = where(b)
            got[task] += len(ids)
            if task in last:
                last[task].append(ids)
            if tally["record"]:
                tally["batches"] += 1
                if ctx["trace"]:
                    tally["stats"].append(work.stats(task, b.arrays,
                                                     len(ids), cfg))
            return lead, ids
        return counted

    def whole_pass(args):
        got.clear()
        for q in last.values():
            q.clear()
        out = one_pass(job, device, args, watch)
        tally["missing"] += sum(max(0, due[t] - got[t]) for t in due)
        return out

    with tempfile.TemporaryDirectory(prefix="pb-joint-") as out_dir:
        args = types.SimpleNamespace(scores_file=None, data_dir=out_dir,
                                     data_split="dev")
        whole_pass(args)         # set-up: every shape, every kernel built
        program.sync(device)
        seconds = (min(ctx["seconds"], spec["trace_seconds"]) if ctx["trace"]
                   else ctx["seconds"])
        traced = Traced(device) if ctx["trace"] else None
        missing_before = tally["missing"]
        tally["record"] = True
        with traced or contextlib.nullcontext():
            t_start = time.perf_counter()
            while True:
                out = whole_pass(args)
                tally["passes"] += 1
                if time.perf_counter() - t_start >= seconds:
                    break
            program.sync(device)
        window = time.perf_counter() - t_start
        tally["record"] = False
        peak = program.memory_peak(device)
        checks = check(ctx["reference"], cfg, job, params, images, boxes,
                       last, out, scores_paths(args))
    failed = tally["missing"] - missing_before
    checks["missing"] = float(tally["missing"])
    passes = tally["passes"]
    return {"window_s": window, "t_start": t_start, "memory_peak": peak,
            "e2e": {"cells_per_s": passes * due["affinity"] / window},
            "attempted": passes * sum(due.values()), "failed": failed,
            "checks": checks, "trace": traced.trace if traced else None,
            "stats": {"stats": tally["stats"], "cfg": cfg,
                      "batches": tally["batches"], "passes": passes}}
