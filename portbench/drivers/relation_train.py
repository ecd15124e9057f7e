"""The window over relation train steps, as the training loop drives them.

One train state (the model, Adam, the dropout seed) is built from the
seed; the program's batcher (grid labels on, ids off) feeds
``to_device``'d batches through the loop's ``prefetch`` thread, each epoch
shuffled by the loop's own ``(seed, epoch)`` stream; the step is
``make_relation_train_step`` with the grid loss, and the host reads the
loss every ``log_every`` steps, as the loop logs it.  Checkpoints and evals
are off.  The cell's file states the precision, the compute dtype
(``compute_dtype``, ``f32`` or ``bf16``), the dropout, the class weights and
the learning rate.  Set-up runs the first epoch (every bucket shape, every
kernel built); the window continues the same state and feed.

Correctness: the first ``checked_steps`` steps of set-up are the window's
own calls on rows that all differ.  Their losses, the first gradient as
Adam holds it after one step (``exp_avg / (1 - b1)``) and the parameters
after the last checked step are kept; after the window the plain reference
runs the same steps from the same weights on the same images and dropout
seeds: the first step's loss and the worst step's, and the gradient and the
change, leaf by leaf.
"""

from __future__ import annotations

import contextlib
import itertools
import time

import numpy as np
import torch

from portbench.lib import program, synth
from portbench.lib.trace import Traced, span
from portbench.lib.weights import make_params, make_table

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _image_key(captions) -> bytes:
    return b"|".join(np.asarray(c, np.int32).tobytes() for c in captions)


def _row_images(arrays: dict, by_key: dict) -> list:
    """The generated images in a batch's rows, read back from its tokens
    (padding rows left out)."""
    out = []
    for s in np.flatnonzero(arrays["img_valid"]):
        lens = arrays["tok_len"][s]
        key = _image_key(arrays["tokens"][s, c, :lens[c]]
                         for c in range(len(lens)) if lens[c] > 0)
        out.append((int(s), by_key[key]))
    return out


def dropout_seeds(seed: int, step: int, n: int) -> np.ndarray:
    """The per-image dropout seeds of a step, as the configuration states
    them: int32 draws in [0, 2**31 - 1) from (seed, step)."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, step & 0xFFFFFFFF]))
    return rng.integers(0, 2 ** 31 - 1, n, dtype=np.int32)


def _leaf_gaps(got: dict, want: dict, counted=None) -> float:
    """max over leaves of |norm(got) - norm(want)| / max(norm(want), the
    median leaf's norm); a leaf missing from ``got`` has norm 0."""
    keys = [k for k in want if counted is None or k in counted]
    norms = {k: float(want[k].float().norm()) for k in want}
    med = float(np.median(list(norms.values())))
    return max(abs((float(got[k].float().norm()) if k in got else 0.0)
                   - norms[k]) / max(norms[k], med, 1e-30) for k in keys)


def run(ctx: dict) -> dict:
    from icl_torch.cli._common import to_device
    from icl_torch.data.buckets import BucketSpec
    from icl_torch.data.imagebatch import RelationBatcher
    from icl_torch.models.relation import RelationModel
    from icl_torch.train import steps as program_steps
    from icl_torch.train.loop import prefetch
    from icl_torch.train.state import create_train_state

    cell, seed, device = ctx["cell"], ctx["seed"], ctx["device"]
    spec, traffic, cfg = cell["spec"], cell["traffic"], cell["config"]
    prec = program.set_precision(spec["precision"], device, predict=False,
                                 tf32=True if ctx.get("control") else None)
    images = synth.relation_images(cfg, traffic["images"], seed)
    by_key = {_image_key(im["captions"]): im for im in images}
    ds = program.relation_dataset(images)
    params = make_params(cfg, seed, device)
    table = make_table(cfg, seed, device)
    cd = DTYPES[spec.get("compute_dtype", "f32")]
    model = RelationModel(
        emb_dim=cfg["emb_dim"], lstm_hidden=cfg["lstm_hidden"],
        head_hidden=cfg["head_hidden"], num_classes=cfg["num_classes"],
        fused=True, dropout=spec["dropout"], device=device,
        compute_dtype=cd, exact=prec.head_exact)
    state = create_train_state(model, seed=seed,
                               learn_rate=spec["learn_rate"],
                               params={k: v.clone() for k, v in
                                       params.items()})
    step_fn = program_steps.make_relation_train_step(
        class_weights=spec["class_weights"], grid_loss=True)
    batcher = RelationBatcher(
        images_per_batch=traffic["images_per_batch"],
        len_spec=BucketSpec((16, 32, 48)),
        mention_spec=BucketSpec((8, 16, 32)), build_grid=True, with_ids=False)

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
        checked.append((host, dropout_seeds(seed, k, len(host["img_valid"]))))
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
    steps_in = [([im for _, im in _row_images(host, by_key)],
                 [seeds[s] for s, _ in _row_images(host, by_key)])
                for host, seeds in checked]
    ref = ctx["reference"].train(params, table, steps_in,
                                 spec["class_weights"], spec["dropout"],
                                 spec["learn_rate"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    gnorm = {k: float(g.norm()) for k, g in ref["grad"].items()}
    med = float(np.median(list(gnorm.values())))
    moved = {k for k, v in gnorm.items() if v >= 1e-3 * med}
    change_p = {k: after[k] - params[k] for k in params}
    change_r = {k: ref["params"][k] - params[k] for k in params}
    checks = {"first_loss_gap": gaps[0], "loss_gap": max(gaps),
              "grad_gap": _leaf_gaps(grad, ref["grad"]),
              "change_gap": _leaf_gaps(change_p, change_r, moved)}
    return {"window_s": window, "t_start": t_start, "memory_peak": peak,
            "e2e": {"train_step_ms": window / max(n_steps, 1) * 1e3},
            "attempted": n_steps, "failed": 0, "checks": checks,
            "trace": traced.trace if traced else None,
            "stats": {"stats": stats, "steps": n_steps, "cfg": cfg}}
