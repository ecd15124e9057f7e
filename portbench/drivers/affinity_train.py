"""The window over affinity train steps, as ``icl-torch-affinity --train``
drives them.

One train state (the model, Adam, the dropout seed) is built from the
seed; the program's ``AffinityBatcher`` (grid labels, ids off, the CLI's
buckets of 8, 16 and 32 phrases and boxes) feeds batches through the
loop's ``prefetch`` thread, which also makes their ``to_device`` copy, as
the CLI's ``make_batches`` does; each epoch is shuffled by the loop's own
``(seed, epoch)`` stream.  The step is ``make_affinity_train_step`` with
the grid loss and no class weights, as the CLI makes it, and the host
reads the loss every ``log_every`` steps.  Checkpoints and evals are off.
The cell's file states the precision, the compute dtype, the dropout and
the learning rate.  Set-up runs the first epoch (every bucket shape, every
kernel built); the window continues the same state and feed.

Labels: the generator carries none for affinity.  Each phrase is made
positive on one of its image's boxes, drawn uniformly from the seed, and
every (phrase, box) cell of an image is a candidate.  With no class
weights every candidate has weight 1, so the kernels walk the same cells
whatever the labels are.

Correctness: as ``drivers/relation_train.py`` checks it.  The first
``checked_steps`` steps of set-up are the window's own calls; their
losses, the first gradient as Adam holds it after one step and the
parameters after the last checked step are kept, and the plain reference
runs the same steps from the same weights on the images the batches held
(read back from their phrase tokens; the buckets round up and cut
nothing) and the same dropout seeds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time

import numpy as np
import torch

from portbench.lib import cell as cells
from portbench.lib import program, synth
from portbench.lib.trace import Traced, span
from portbench.lib.weights import make_params, make_table

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
LABEL_STREAM = 11    # the labels' salt of the seed's stream

# the relation train driver's dropout seeds and leaf-by-leaf gaps
_relation = cells.load_module(cells.part("drivers", "relation_train"))


def draw_labels(images: list[dict], seed: int) -> list[np.ndarray]:
    """Each image's int32 [M, n_boxes] grid: every phrase positive (1) on
    one box drawn uniformly from its image's, from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, LABEL_STREAM]))
    out = []
    for im in images:
        M, nb = len(im["phrases"]), im["n_boxes"]
        grid = np.zeros((M, nb), np.int32)
        grid[np.arange(M), rng.integers(0, nb, M)] = 1
        out.append(grid)
    return out


def _image_key(phrases) -> bytes:
    return b"|".join(np.asarray(p, np.int32).tobytes() for p in phrases)


def _row_images(arrays: dict, by_key: dict) -> list:
    """The generated images in a batch's rows, read back from their phrase
    tokens (padding rows left out)."""
    out = []
    for s in np.flatnonzero(arrays["img_valid"]):
        lens = arrays["phrase_len"][s]
        key = _image_key(arrays["phrase_tokens"][s, r, :lens[r]]
                         for r in range(len(lens)) if lens[r] > 0)
        out.append((int(s), by_key[key]))
    return out


def run(ctx: dict) -> dict:
    from icl_torch.cli._common import to_device
    from icl_torch.data.buckets import BucketSpec
    from icl_torch.data.imagebatch import AffinityBatcher
    from icl_torch.models.affinity import AffinityModel
    from icl_torch.train import steps as program_steps
    from icl_torch.train.loop import prefetch
    from icl_torch.train.state import create_train_state

    cell, seed, device = ctx["cell"], ctx["seed"], ctx["device"]
    spec, traffic, cfg = cell["spec"], cell["traffic"], cell["config"]
    prec = program.set_precision(spec["precision"], device, predict=False,
                                 tf32=True if ctx.get("control") else None)
    cd = DTYPES[spec.get("compute_dtype", "f32")]
    images = synth.affinity_images(cfg, traffic["images"], seed)
    images = [{**im, "labels": lab}
              for im, lab in zip(images, draw_labels(images, seed))]
    by_key = {_image_key(im["phrases"]): im for im in images}
    boxes = synth.box_block(sum(im["n_boxes"] for im in images),
                            cfg["box_dim"], seed, device)
    ds = program.affinity_dataset(images, boxes, cfg["phrase_len"])
    ds.images = [dataclasses.replace(rec, grid_label=im["labels"])
                 for rec, im in zip(ds.images, images)]
    params = make_params(cfg, seed, device)
    table = make_table(cfg, seed, device)
    model = AffinityModel(
        emb_dim=cfg["emb_dim"], box_dim=cfg["box_dim"],
        lstm_hidden=cfg["lstm_hidden"], head_hidden=cfg["head_hidden"],
        num_classes=cfg["num_classes"], fused=True, dropout=spec["dropout"],
        device=device, compute_dtype=cd, exact=prec.head_exact)
    state = create_train_state(model, seed=seed,
                               learn_rate=spec["learn_rate"],
                               params={k: v.clone() for k, v in
                                       params.items()})
    step_fn = program_steps.make_affinity_train_step(
        class_weights=spec["class_weights"], grid_loss=True)
    buckets = BucketSpec((8, 16, 32))
    batcher = AffinityBatcher(
        images_per_batch=traffic["images_per_batch"], mention_spec=buckets,
        box_spec=buckets, phrase_len=cfg["phrase_len"], box_dtype=cd,
        with_ids=False)

    def feed():
        for epoch in itertools.count():
            rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
            for b in batcher.batches(ds, rng=rng):
                yield to_device(b.arrays, device), b.arrays, epoch

    prog_table = table.to(cd)
    it = prefetch(feed())
    names = {id(p): n.replace(".", "/") for n, p in
             model.named_parameters()}

    # the checked steps: the window's own call and feed
    checked, losses, grad = [], [], {}
    for k in range(traffic["checked_steps"]):
        jb, host, _ = next(it)
        metrics = step_fn(state, prog_table, jb)
        losses.append(float(metrics["loss"]))
        checked.append((host, _relation.dropout_seeds(
            seed, k, len(host["img_valid"]))))
        if k == 0:
            grad = {names[id(p)]: (s["exp_avg"] / 0.1).detach().clone()
                    for p, s in state.optimizer.state.items()}
    after = {names[id(p)]: p.detach().clone() for p in model.parameters()}
    epoch = 0
    while epoch == 0:                     # the rest of the first epoch
        jb, host, epoch = next(it)
        step_fn(state, prog_table, jb)
    program.sync(device)

    work = ctx["work"]
    log_every = traffic["log_every"]
    n_steps, stats = 0, []
    seconds = (min(ctx["seconds"], spec["trace_seconds"]) if ctx["trace"]
               else ctx["seconds"])
    traced = Traced(device) if ctx["trace"] else None
    with traced or contextlib.nullcontext():
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            with span("wait_batch"):
                jb, host, _ = next(it)
            if ctx["trace"]:
                stats.append(work.stats(host, cfg))
            with span("step"):
                metrics = step_fn(state, prog_table, jb)
            n_steps += 1
            if n_steps % log_every == 0:
                with span("log"):
                    float(metrics["loss"])
        program.sync(device)
    window = time.perf_counter() - t_start
    it.close()
    peak = program.memory_peak(device)
    del state, model, step_fn, it, jb, metrics, prog_table
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # the check: the plain reference over the same steps
    steps_in = []
    for host, seeds in checked:
        rows = _row_images(host, by_key)
        steps_in.append(([im for _, im in rows], [seeds[s] for s, _ in rows]))
    ref = ctx["reference"].train(params, table, boxes, steps_in,
                                 spec["dropout"], spec["learn_rate"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    gnorm = {k: float(g.norm()) for k, g in ref["grad"].items()}
    med = float(np.median(list(gnorm.values())))
    moved = {k for k, v in gnorm.items() if v >= 1e-3 * med}
    change_p = {k: after[k] - params[k] for k in params}
    change_r = {k: ref["params"][k] - params[k] for k in params}
    checks = {"first_loss_gap": gaps[0], "loss_gap": max(gaps),
              "grad_gap": _relation._leaf_gaps(grad, ref["grad"]),
              "change_gap": _relation._leaf_gaps(change_p, change_r, moved)}
    return {"window_s": window, "t_start": t_start, "memory_peak": peak,
            "e2e": {"train_step_ms": window / max(n_steps, 1) * 1e3},
            "attempted": n_steps, "failed": 0, "checks": checks,
            "trace": traced.trace if traced else None,
            "stats": {"stats": stats, "steps": n_steps, "cfg": cfg}}
