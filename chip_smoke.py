#!/usr/bin/env python3
"""Smoke test of the PyTorch port (icl_torch) on one NVIDIA GPU.

Drives the port's two paths, relation scoring served over HTTP and
relation training, at full width (BiLSTM 200 per direction over 300-d word
vectors, head 800, O = 4, f32, TF32 off) with random weights made from a
seed:

1. prints the card's name and power limit (nvidia-smi) and the versions;
2. builds the three hand-written CUDA sources from icl_torch/csrc, one nvcc
   each, side by side, and prints ptxas's registers and spills;
3. checks each kernel against its plain PyTorch version on the card (gate:
   max |kernel - plain| <= 1e-5 * max(1, max |plain|)): the grid head and
   the recurrence at the served shapes, the recurrence's training residuals
   (gates, c) at L=32 B=512, and the four training grid-head kernels (K5
   forward, K6 backward, K7 loss forward, K8 loss backward) at G in {1, 64},
   A = B in {8, 16, 32}, K=800, O=4, dropout rate 0 and 0.5 (kernels and
   plain versions share one hash mask); then times each kernel against its
   plain version, per call with CUDA events over back-to-back calls, and
   device time alone with the profiler;
4. serving: writes a data dir (synthetic 300-d word vectors, seeded weights
   as an icl-export archive), serves it with icl_torch.serve on 127.0.0.1
   and sends Flickr30k-shaped requests (8 single-image requests, one
   8-image request, 4 concurrent ones, a repeat that must come back
   byte-identical); served probs match the plain model within 1e-5; the
   grid head and the recurrence launch over the requests;
5. training: a planted synthetic dataset of 128 images (up to 32 tokens,
   up to 15 mentions), batched 64 images at a time, trains the fused model
   5 steps with the grid loss at dropout 0.5 and class weights
   [0.3, 1, 1, 1], then 2 steps with null weight 0 (the guard takes the
   pair form), then scores a batch.  At the first step of each form the
   kernel path's loss, metrics and every parameter gradient are held
   against the plain model's from the same params and seeds; every loss is
   finite; all six kernels launch in this phase; per-step times of the
   kernel path and the plain path;
6. prints the times beside the card;
7. prints one JSON line with the kernels' launches, errors and times, then,
   last, {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed phase exits non-zero before the last line; without a CUDA
device it exits 2 at once, and without the repository around it the
imports fail.  Usage, from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from icl.data.embeddings import EmbeddingStore
from icl.data.imagebatch import RelationBatcher
from icl.data.pipeline import load_relation_dataset
from icl.testing.synth import SynthConfig, generate_dataset
from icl_torch.models.relation import RelationModel
from icl_torch.ops import _build
from icl_torch.ops import grid_head_train as ght
from icl_torch.ops.grid_head import grid_head, grid_head_reference
from icl_torch.ops.lstm_recurrence import (lstm_recurrence,
                                           lstm_recurrence_fwd,
                                           lstm_recurrence_reference)
from icl_torch.params import init_relation_params, save_npz
from icl_torch.serve import serve
from icl_torch.train.state import create_train_state
from icl_torch.train.steps import (make_relation_train_step, relation_loss,
                                   relation_predict)

KERNEL_GATE = 1e-5     # relative to max(1, max |plain|), f32, TF32 off
PROBS_GATE = 1e-5      # served probs (6 decimals) vs the plain model
DIMS = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 800}
VOCAB = 2000
SEED = 0
RATE = 0.5             # relation dropout (icl-relation's default)
SOURCES = ("grid_head", "lstm_recurrence", "grid_head_train")
TRAIN_KERNELS = {      # name -> wrapper carrying the launch count
    "grid_head_train_fwd": ght.grid_head_train_fwd,
    "grid_head_train_bwd": ght.grid_head_train_bwd,
    "grid_head_train_loss_fwd": ght.grid_head_train_loss_fwd,
    "grid_head_train_loss_bwd": ght.grid_head_train_loss_bwd,
}
REPLACES = {           # name -> (source, TPU kernel it replaces)
    "grid_head": ("icl_torch/csrc/grid_head.cu", "icl/ops/grid_head.py:147"),
    "lstm_recurrence": ("icl_torch/csrc/lstm_recurrence.cu",
                        "icl/ops/lstm_kernel.py:109"),
    "grid_head_train_fwd": ("icl_torch/csrc/grid_head_train.cu",
                            "icl/ops/grid_head_train.py:266"),
    "grid_head_train_bwd": ("icl_torch/csrc/grid_head_train.cu",
                            "icl/ops/grid_head_train.py:303"),
    "grid_head_train_loss_fwd": ("icl_torch/csrc/grid_head_train.cu",
                                 "icl/ops/grid_head_train.py:706"),
    "grid_head_train_loss_bwd": ("icl_torch/csrc/grid_head_train.cu",
                                 "icl/ops/grid_head_train.py:789"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the shared data layer's optional C++ reader is not needed here
    os.environ.setdefault("ICL_NO_NATIVE_BUILD", "1")
    dev = torch.device("cuda")

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build, one nvcc per source, all at once
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(_build.build, SOURCES))
    for name, (path, secs) in zip(SOURCES, built):
        print(f"build {name}: {secs:.1f} s -> {path.name}")
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {line.strip()}")

    # 3. kernels vs plain versions
    gen = torch.Generator(device=dev).manual_seed(SEED)
    failures = []

    def check(what, got, want, gate=KERNEL_GATE, quiet=False):
        err = _max_err(got, want)
        tol = gate * max(1.0, _max_abs(want))
        ok = err <= tol and all(bool(torch.isfinite(g).all())
                                for g in _tuple(got))
        if not ok or not quiet:
            print(f"check {what}: max|d| {err:.3e} (gate {tol:.1e}) "
                  f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)
        return err, tol

    def head_inputs(G, M):
        K, O = DIMS["head_hidden"], 4
        return (torch.randn(G, M, K, generator=gen, device=dev),
                torch.randn(G, M, K, generator=gen, device=dev),
                torch.randn(K, generator=gen, device=dev),
                torch.randn(K, O, generator=gen, device=dev) / K ** 0.5,
                torch.randn(O, generator=gen, device=dev))

    def train_inputs(G, M):
        """The arguments of K5-K8, rate aside, over one random problem."""
        X, Y, b1, W2, b2 = head_inputs(G, M)
        seeds = torch.randint(0, 2 ** 31 - 1, (G,), generator=gen,
                              device=dev, dtype=torch.int32)
        labels = torch.randint(0, 4, (G, M, M), generator=gen, device=dev,
                               dtype=torch.int32)
        weights = ((torch.rand(G, M, M, generator=gen, device=dev) > 0.25)
                   * torch.where(torch.rand(G, M, M, generator=gen,
                                            device=dev) > 0.5, 1.0, 0.3))
        cot = torch.randn(G, M, M, 4, generator=gen, device=dev)
        gl = torch.rand((), generator=gen, device=dev)
        return {"grid_head_train_fwd": (X, Y, b1, W2, b2, seeds),
                "grid_head_train_bwd": (X, Y, b1, W2, seeds, cot),
                "grid_head_train_loss_fwd": (X, Y, b1, W2, b2, seeds, labels,
                                             weights),
                "grid_head_train_loss_bwd": (X, Y, b1, W2, b2, seeds, labels,
                                             weights, gl)}

    def rec_inputs(L, B):
        H = DIMS["lstm_hidden"]
        lengths = torch.randint(0, L + 1, (B,), generator=gen, device=dev)
        lengths[0], lengths[-1] = 0, L
        t = torch.arange(L, device=dev)[:, None]
        mask = torch.stack([t < lengths, (L - 1 - t) < lengths])
        return (torch.randn(2, L, B, 4 * H, generator=gen, device=dev),
                mask.contiguous(),
                torch.randn(2, H, 4 * H, generator=gen, device=dev) / H ** .5)

    plain_of = {"grid_head_train_fwd": ght.grid_head_train_reference,
                "grid_head_train_bwd": ght.grid_head_train_bwd_plain,
                "grid_head_train_loss_fwd": ght.grid_head_train_loss_reference,
                "grid_head_train_loss_bwd": ght.grid_head_train_loss_bwd_plain}

    for G in (1, 8, 64):
        for M in (8, 16, 32):
            args = head_inputs(G, M)
            check(f"grid_head G={G} A=B={M} K=800 O=4", grid_head(*args),
                  grid_head_reference(*args))
    empty = grid_head(*head_inputs(8, 0))
    if empty.shape != (8, 0, 0, 4):
        failures.append("grid_head empty grid")
    print(f"check grid_head empty grid: shape {tuple(empty.shape)}")
    for L in (16, 32, 48):
        for B in (8, 40, 64):
            args = rec_inputs(L, B)
            hs, fin = lstm_recurrence(*args)
            hs_ref, fin_ref = lstm_recurrence_reference(*args)
            check(f"lstm_recurrence L={L} B={B} H=200 hs", hs, hs_ref)
            check(f"lstm_recurrence L={L} B={B} H=200 final", fin, fin_ref)
    for L, B in ((32, 512), (16, 64)):
        args = rec_inputs(L, B)
        got = lstm_recurrence_fwd(*args, residuals=True)
        bare = lstm_recurrence_fwd(*args)
        if not (torch.equal(got[0], bare[0]) and torch.equal(got[1], bare[1])):
            failures.append(f"lstm_recurrence residuals L={L} B={B} changed hs")
        check(f"lstm_recurrence residuals L={L} B={B} H=200 (hs, final, "
              f"gates, c)", got, lstm_recurrence_reference(*args, True))
    for G in (1, 64):
        for M in (8, 16, 32):
            cases = train_inputs(G, M)
            for rate in (0.0, RATE):
                errs = {name: check(f"{name} G={G} A=B={M} rate={rate}",
                                    TRAIN_KERNELS[name](*a, rate),
                                    plain_of[name](*a, rate), quiet=True)
                        for name, a in cases.items()}
                print(f"check grid_head_train K5-K8 G={G} A=B={M} K=800 O=4 "
                      f"rate={rate}: max|d| (gate) " + ", ".join(
                          f"{n[16:]} {e:.2e} ({t:.1e})"
                          for n, (e, t) in errs.items()))
    e_args = train_inputs(8, 0)
    for name, a in e_args.items():
        out = TRAIN_KERNELS[name](*a, RATE)
        if any(t.numel() and t.any() for t in _tuple(out)):
            failures.append(f"{name} empty grid")
    print("check grid_head_train K5-K8 empty grid: zeros")
    if failures:
        raise RuntimeError(f"kernel checks failed: {failures}")

    # timings: the served 8-image shape for the predict kernels; the
    # training batch's shape (64 images, 16 mentions) for the training ones
    head_args = head_inputs(8, 16)
    rec_args = rec_inputs(32, 64)
    big_rec = rec_inputs(32, 512)
    train_args = train_inputs(64, 16)
    cases = {
        "grid_head": (lambda: grid_head(*head_args),
                      lambda: grid_head_reference(*head_args),
                      "G=8 A=B=16 K=800 O=4"),
        "lstm_recurrence": (lambda: lstm_recurrence(*rec_args)[0],
                            lambda: lstm_recurrence_reference(*rec_args)[0],
                            "G=2 L=32 B=64 H=200"),
        "lstm_recurrence with residuals": (
            lambda: lstm_recurrence_fwd(*big_rec, residuals=True),
            lambda: lstm_recurrence_reference(*big_rec, residuals=True),
            "G=2 L=32 B=512 H=200"),
    }
    for name, a in train_args.items():
        cases[name] = ((lambda f=TRAIN_KERNELS[name], a=a: f(*a, RATE)),
                       (lambda f=plain_of[name], a=a: f(*a, RATE)),
                       f"G=64 A=B=16 K=800 O=4 rate={RATE}")
    timing = {name: {"shape": shape,
                     "max_abs_err": _max_err(fn(), plain()),
                     "ms": _time_ms(fn),
                     "plain_ms": _time_ms(plain),
                     "device_ms": _device_ms(fn),
                     "plain_device_ms": _device_ms(plain)}
              for name, (fn, plain, shape) in cases.items()}

    # 4. serving
    with tempfile.TemporaryDirectory(prefix="icl_chip_smoke_") as d:
        generate_dataset(d, "train", SynthConfig(
            num_images=1, emb_dim=DIMS["emb_dim"], vocab_size=VOCAB,
            seed=SEED))
        flat = init_relation_params(SEED, DIMS)
        save_npz(f"{d}/relation.npz", flat, {"task": "relation", **DIMS})
        httpd = serve(d, port=0, warmup="basic")
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        try:
            result = _drive(httpd)
            scorer = httpd.RequestHandlerClass.scorer
            plain = RelationModel(DIMS["emb_dim"], DIMS["lstm_hidden"],
                                  DIMS["head_hidden"], fused=False,
                                  device=dev)
            plain.load_flat(flat)
            prepped = [scorer._prep_relation_image(img)
                       for img in result["images"]]
            want = relation_predict(plain, scorer.table, scorer._stack_arrays(
                [p[1] for p in prepped])).cpu().numpy()
            got = np.array([[p["probs"] for p in im["pairs"]]
                            for im in result["batch_body"]["images"]])
            perr = float(np.abs(got - want[:, :got.shape[1]]).max())
            print(f"check served probs vs plain model on the card: "
                  f"max|d| {perr:.3e} (gate {PROBS_GATE:.0e}) "
                  f"{'ok' if perr <= PROBS_GATE else 'FAIL'}")
            if perr > PROBS_GATE:
                raise RuntimeError("served probs disagree with the plain "
                                   "model")
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=10)

    # 5. training
    train = _train(dev, check)
    if failures:
        raise RuntimeError(f"training checks failed: {failures}")

    # 6. times, each beside the card
    for name, t in timing.items():
        print(f"time {name} [{t['shape']}]: per call kernel {t['ms']:.4f} "
              f"ms, plain {t['plain_ms']:.4f} ms; device kernel "
              f"{t['device_ms']:.4f} ms, plain {t['plain_device_ms']:.4f} ms "
              f"({card})")
    lat = result["latency_ms"]
    print(f"time request p50: client {lat['client_p50']:.2f} ms over "
          f"{lat['n']} single-image requests, server predict p50 "
          f"{lat['server_p50']} ms; 8-image request {lat['batch_ms']:.2f} ms "
          f"({card})")
    print(f"time train step [{train['shape']}], grid loss, dropout {RATE}: "
          f"kernel path {train['step_ms']:.2f} ms, plain path "
          f"{train['plain_step_ms']:.2f} ms per step ({card})")

    # 7. result lines
    launches = {**result["launches"],
                **{k: train["launches"][k] for k in TRAIN_KERNELS}}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": timing[name]["max_abs_err"],
                "ms": timing[name]["ms"],
                "plain_ms": timing[name]["plain_ms"]}
               for name, (src, replaces) in REPLACES.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _max_abs(x) -> float:
    return max((t.abs().max().item() for t in _tuple(x) if t.numel()),
               default=0.0)


def _max_err(got, want) -> float:
    got, want = _tuple(got), _tuple(want)
    if len(got) != len(want) or any(a.shape != b.shape
                                    for a, b in zip(got, want)):
        return float("inf")
    return max(((a - b).abs().max().item() for a, b in zip(got, want)
                if b.numel()), default=0.0)


def _time_ms(fn, iters: int = 50) -> float:
    """Mean time per fn() call over iters back-to-back calls, by CUDA
    events: the device's time, or the host's where the host is slower."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 20) -> float:
    """Mean device time per fn() call: the summed time of the GPU work the
    profiler records over iters calls, without the host's share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total
               for e in prof.key_averages()) / iters / 1e3


def _train(dev, check) -> dict:
    """The training path: 5 grid-loss steps, 2 pair-form steps, a scoring
    pass; counts the launches of all six kernels over it."""
    with tempfile.TemporaryDirectory(prefix="icl_chip_train_") as d:
        generate_dataset(d, "train", SynthConfig(
            planted=True, emb_dim=DIMS["emb_dim"], vocab_size=VOCAB,
            max_caption_len=32, max_mentions_per_caption=3, num_images=128,
            seed=SEED))
        emb = EmbeddingStore.load(f"{d}/embeddings.txt")
        ds = load_relation_dataset(d, "train", emb)
    table = torch.from_numpy(emb.table).to(dev)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.arrays.items()}
               for b in RelationBatcher(images_per_batch=64,
                                        build_grid=True).batches(ds)]
    # the fullest batch first: 64 images of up to 32 tokens, 16 mentions
    batches.sort(key=lambda b: -int(b["pair_valid"].sum()))
    model = RelationModel(**DIMS, fused=True, dropout=RATE, device=dev)
    state = create_train_state(model, seed=SEED)
    plain = RelationModel(**DIMS, fused=False, dropout=RATE, device=dev)

    grid_head.launches = 0
    lstm_recurrence.launches = 0
    for fn in TRAIN_KERNELS.values():
        fn.launches = 0
    losses = []
    for form, cw, n in (("grid", [0.3, 1.0, 1.0, 1.0], 5),
                        ("pair", [0.0, 1.0, 1.0, 1.0], 2)):
        step = make_relation_train_step(class_weights=cw, grid_loss=True)
        for i in range(n):
            batch = batches[len(losses) % len(batches)]
            if i == 0:      # the plain model's step from the same params
                plain.load_flat(model.flat_params())
                plain.zero_grad(set_to_none=True)
                loss_p, want = relation_loss(
                    plain, table, batch, state.dropout_seeds(
                        batch["tokens"].shape[0]),
                    torch.tensor(cw, device=dev), step.grid_loss)
                loss_p.backward()
            metrics = step(state, table, batch)
            loss = metrics["loss"].item()
            losses.append(loss)
            print(f"train step {state.step} ({form} form): loss {loss:.6f} "
                  f"acc {metrics['acc'].item():.4f}")
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {state.step}")
            if i == 0:
                for k, v in want.items():
                    check(f"train {form} form step 1 {k}: kernel path vs "
                          f"plain", metrics[k], v.detach())
                grads = dict(plain.named_parameters())
                errs = [check(f"train {form} form grad {k}", p.grad,
                              grads[k].grad, quiet=True)
                        for k, p in model.named_parameters()]
                print(f"check train {form} form step 1: {len(errs)} "
                      f"parameter gradients, kernel path vs plain, max|d| "
                      f"{max(e for e, _ in errs):.3e} (smallest gate "
                      f"{min(t for _, t in errs):.1e})")
    probs = relation_predict(model, table, batches[0])
    valid = batches[0]["pair_valid"]
    if (not torch.isfinite(probs).all()
            or (probs.sum(-1) - 1).abs().max().item() > 1e-5):
        raise RuntimeError("scoring after training: bad probabilities")
    acc = ((probs.argmax(-1) == batches[0]["pair_label"]) & valid).sum() \
        / valid.sum()
    torch.cuda.synchronize()
    launches = {"grid_head": grid_head.launches,
                "lstm_recurrence": lstm_recurrence.launches,
                **{k: fn.launches for k, fn in TRAIN_KERNELS.items()}}
    print(f"check launches over the training path: {launches}")
    print(f"train: losses {[round(x, 6) for x in losses]}, pair accuracy "
          f"after training {acc.item():.4f} over {int(valid.sum())} pairs")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel was not launched: {launches}")

    # per-step times of both paths on the fullest batch, grid loss
    batch = batches[0]
    step = make_relation_train_step(class_weights=[0.3, 1.0, 1.0, 1.0],
                                    grid_loss=True)
    plain_state = create_train_state(plain, params=model.flat_params())
    times = {}
    for name, st in (("kernel", state), ("plain", plain_state)):
        step(st, table, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step(st, table, batch)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) / 5 * 1e3
    I, C, L = batch["tokens"].shape
    return {"launches": launches, "step_ms": times["kernel"],
            "plain_step_ms": times["plain"],
            "shape": f"I={I} C={C} L={L} M={batch['m_cap'].shape[1]}"}


def _image(rng, k: int) -> dict:
    """A Flickr30k-shaped image: 5 captions of 12..32 tokens, 16 mentions
    spread over them; no "pairs" key, so all 120 pairs i < j are scored."""
    caps = [[f"w{int(t):03d}" for t in rng.integers(0, VOCAB, n)]
            for n in rng.integers(12, 33, 5)]
    ments = []
    for m in range(16):
        c = m % 5
        first = int(rng.integers(0, len(caps[c]) - 1))
        ments.append({"caption": c, "first": first,
                      "last": min(first + int(rng.integers(0, 3)),
                                  len(caps[c]) - 1)})
    return {"id": f"img{k}", "captions": caps, "mentions": ments}


def _post(url: str, obj: dict) -> tuple[int, bytes, float]:
    req = urllib.request.Request(
        url + "/score/relation", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read()
        return r.status, body, (time.perf_counter() - t0) * 1e3


def _check_body(body: dict, n_images: int) -> None:
    if len(body["images"]) != n_images:
        raise RuntimeError(f"{len(body['images'])} images in the response, "
                           f"{n_images} sent")
    for im in body["images"]:
        probs = np.array([p["probs"] for p in im["pairs"]])
        if probs.shape != (120, 4) or not np.isfinite(probs).all():
            raise RuntimeError(f"bad probs for {im['id']}: {probs.shape}")
        if np.abs(probs.sum(-1) - 1).max() > 1e-5:
            raise RuntimeError(f"probs of {im['id']} do not sum to 1")


def _drive(httpd) -> dict:
    """The served path: HTTP requests through the server; counts launches."""
    url = f"http://127.0.0.1:{httpd.server_port}"
    rng = np.random.default_rng(SEED)
    singles = [_image(rng, k) for k in range(8)]
    batch = [_image(rng, 8 + k) for k in range(8)]
    grid_head.launches = 0
    lstm_recurrence.launches = 0

    lat, first = [], None
    for img in singles:
        status, raw, ms = _post(url, {"images": [img]})
        if status != 200:
            raise RuntimeError(f"single request: HTTP {status}")
        _check_body(json.loads(raw), 1)
        lat.append(ms)
        first = first or raw
    status, raw, batch_ms = _post(url, {"images": batch})
    if status != 200:
        raise RuntimeError(f"8-image request: HTTP {status}")
    batch_body = json.loads(raw)
    _check_body(batch_body, 8)

    results = [None] * 4

    def fire(k):
        results[k] = _post(url, {"images": [singles[k]]})

    threads = [threading.Thread(target=fire, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    for r in results:
        if r is None or r[0] != 200:
            raise RuntimeError(f"concurrent request failed: {r and r[0]}")
        _check_body(json.loads(r[1]), 1)

    status, again, _ = _post(url, {"images": [singles[0]]})
    if again != first:
        raise RuntimeError("a repeated request gave different bytes")
    print("check repeated request: byte-identical JSON ok")
    torch.cuda.synchronize()
    launches = {"grid_head": grid_head.launches,
                "lstm_recurrence": lstm_recurrence.launches}
    print(f"check launches over the requests: {launches}")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel was not launched: {launches}")

    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    if health["status"] != "ok" or health["coalescer"]["items"] < 21:
        raise RuntimeError(f"bad /healthz: {health}")
    print(f"check /healthz: {json.dumps(health)}")
    lat.sort()
    return {"images": batch, "batch_body": batch_body, "launches": launches,
            "latency_ms": {
                "client_p50": lat[len(lat) // 2], "n": len(lat),
                "server_p50": health["latency_ms"]["relation"]["p50_ms"],
                "batch_ms": batch_ms}}


if __name__ == "__main__":
    sys.exit(main())
