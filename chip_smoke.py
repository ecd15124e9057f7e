#!/usr/bin/env python3
"""Smoke test of the PyTorch port (icl_torch) on one NVIDIA GPU.

Drives the port's main path, relation scoring served over HTTP, at full
width (BiLSTM 200 per direction over 300-d word vectors, head 800, f32,
TF32 off) with random weights made from a seed:

1. prints the card's name and power limit (nvidia-smi) and the versions;
2. builds both hand-written CUDA kernels from icl_torch/csrc with nvcc;
3. checks each kernel against its plain PyTorch version on the card at the
   served shapes (gate: max |kernel - plain| <= 1e-5 * max(1, max |plain|))
   and times both: per call with CUDA events over back-to-back calls (the
   host's share included where it dominates), and device time alone with
   the profiler;
4. writes a data dir: synthetic 300-d word vectors and seeded relation
   weights as an icl-export archive;
5. serves it with icl_torch.serve on 127.0.0.1 and sends Flickr30k-shaped
   requests (5 captions of up to 32 tokens, 16 mentions, all 120 pairs per
   image): 8 single-image requests, one 8-image request, 4 concurrent
   requests through the coalescer, and a repeat that must come back
   byte-identical.  Served probabilities sum to 1 and match the plain
   (kernel-free) model on the card within 1e-5; both kernels' launch
   counts over the requests are > 0;
6. prints kernel and plain times and the request p50 beside the card;
7. prints one JSON line with the kernels' launches, errors and times, then,
   last,
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed phase exits non-zero before the last line; without a CUDA
device it exits 2 at once, and without the repository around it the
imports fail.  Usage, from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from icl.testing.synth import SynthConfig, generate_dataset
from icl_torch.models.relation import RelationModel
from icl_torch.ops import _build
from icl_torch.ops.grid_head import grid_head, grid_head_reference
from icl_torch.ops.lstm_recurrence import (lstm_recurrence,
                                           lstm_recurrence_reference)
from icl_torch.params import init_relation_params, save_npz
from icl_torch.serve import serve
from icl_torch.train.steps import relation_predict

KERNEL_GATE = 1e-5     # relative to max(1, max |plain|), f32, TF32 off
PROBS_GATE = 1e-5      # served probs (6 decimals) vs the plain model
DIMS = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 800}
VOCAB = 2000
SEED = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    for name in ("grid_head", "lstm_recurrence"):
        path, secs = _build.build(name)
        print(f"build {name}: {secs:.1f} s -> {path.name}")
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {line.strip()}")

    # 3. kernels vs plain versions at the slice's shapes
    gen = torch.Generator(device=dev).manual_seed(SEED)
    failures = []

    def check(what, got, want):
        err = (got - want).abs().max().item() if want.numel() else 0.0
        tol = KERNEL_GATE * max(1.0, want.abs().max().item()
                                if want.numel() else 0.0)
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"check {what}: max|d| {err:.3e} (gate {tol:.1e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)
        return err

    def head_inputs(G, M):
        K, O = DIMS["head_hidden"], 4
        return (torch.randn(G, M, K, generator=gen, device=dev),
                torch.randn(G, M, K, generator=gen, device=dev),
                torch.randn(K, generator=gen, device=dev),
                torch.randn(K, O, generator=gen, device=dev) / K ** 0.5,
                torch.randn(O, generator=gen, device=dev))

    def rec_inputs(L, B):
        H = DIMS["lstm_hidden"]
        lengths = torch.randint(0, L + 1, (B,), generator=gen, device=dev)
        lengths[0], lengths[-1] = 0, L
        t = torch.arange(L, device=dev)[:, None]
        mask = torch.stack([t < lengths, (L - 1 - t) < lengths])
        return (torch.randn(2, L, B, 4 * H, generator=gen, device=dev),
                mask.contiguous(),
                torch.randn(2, H, 4 * H, generator=gen, device=dev) / H ** .5)

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
    if failures:
        raise RuntimeError(f"kernel checks failed: {failures}")

    # timings at the served 8-image shape: 8 images x 16 mentions, and
    # 8 images x 8 caption slots x 32 tokens
    head_args = head_inputs(8, 16)
    rec_args = rec_inputs(32, 64)
    cases = {
        "grid_head": (lambda: grid_head(*head_args),
                      lambda: grid_head_reference(*head_args),
                      "G=8 A=B=16 K=800 O=4"),
        "lstm_recurrence": (lambda: lstm_recurrence(*rec_args)[0],
                            lambda: lstm_recurrence_reference(*rec_args)[0],
                            "G=2 L=32 B=64 H=200"),
    }
    timing = {name: {"shape": shape,
                     "max_abs_err": (fn() - plain()).abs().max().item(),
                     "ms": _time_ms(fn),
                     "plain_ms": _time_ms(plain),
                     "device_ms": _device_ms(fn),
                     "plain_device_ms": _device_ms(plain)}
              for name, (fn, plain, shape) in cases.items()}

    with tempfile.TemporaryDirectory(prefix="icl_chip_smoke_") as d:
        # 4. data dir: word vectors + seeded full-width weights
        generate_dataset(d, "train", SynthConfig(
            num_images=1, emb_dim=DIMS["emb_dim"], vocab_size=VOCAB,
            seed=SEED))
        flat = init_relation_params(SEED, DIMS)
        save_npz(f"{d}/relation.npz", flat, {"task": "relation", **DIMS})

        # 5. serve and score
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

    # 7. result lines
    sources = {"grid_head": ("icl_torch/csrc/grid_head.cu",
                             "icl/ops/grid_head.py:147"),
               "lstm_recurrence": ("icl_torch/csrc/lstm_recurrence.cu",
                                   "icl/ops/lstm_kernel.py:109")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": result["launches"][name],
                "max_abs_err": timing[name]["max_abs_err"],
                "ms": timing[name]["ms"],
                "plain_ms": timing[name]["plain_ms"]}
               for name, (src, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
    """The main path: HTTP requests through the server; counts launches."""
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
