"""Every kernel entry point's output at chip_smoke.py's phase 3 shapes,
saved for a bitwise comparison between two trees of the repository; the
device times of the training grid-head kernels for comparing them; and
the inputs that chip_smoke.py times those kernels on.

A GPU tool.  One process imports one tree's ``icl_torch`` (the one first
on ``PYTHONPATH``), feeds each entry point seeded inputs and saves the
outputs: the f32 modes (K1/K2, the recurrence with and without its
residuals, at H up to 512, K5-K8 at rate 0 and 0.5, K9), the bf16 modes
(the fast dot of K1/K2 and K9, the bf16 recurrence) and, where the tree
has it, the one-pass bf16 mode of K5-K8 (``exact=False``), on the same
inputs: a tree without a mode draws the same random numbers for the
others.  Since K8 and K6 walk only the cells with a cotangent, K8 also
runs with weights zero but for one cell in every other group of four rows
and K6 with a cotangent zero on the cells of weight 0.  ``--compare``
loads two such files and says, case by case, whether the bits are equal;
it fails on a case of the first file that the second lacks or computes
otherwise, and lists the second's new cases.  Two kinds of case are the
exception, both computed on the tensor cores in another order of the sum
in some tree: the bf16 recurrence's (named ``recurrence bf16 ...``), a
difference reported with its size in bf16 units, as "changed, held to
BF16_REC_ULPS" (chip_smoke.py holds those outputs to the plain version);
and the fast dot's (``grid_head bf16dot ...``, ``affinity_rank bf16dot
...``), whose plain version each file keeps beside it (``... plain``): a
difference passes if the second file's output lies within the f32 gate,
1e-5 * max(1, max |plain|), of its plain version, and is reported with
that distance.  ``--times <label>`` prints,
one JSON line a case and kernel, the device ms (profiler) of K5-K8 in
both modes on chip_smoke.py's timed inputs (:func:`timed_cases`): the
default density 0.75, and the weights and labels of a real training batch
(:func:`trained_batches`).  On one card, from the repository's root, with
the other tree unpacked under ``_archive/parent``::

    PYTHONPATH=_archive/parent python icl_torch/tools/kernel_bits.py p.pt
    PYTHONPATH=. python icl_torch/tools/kernel_bits.py c.pt
    python icl_torch/tools/kernel_bits.py --compare p.pt c.pt
    PYTHONPATH=_archive/parent python icl_torch/tools/kernel_bits.py --times parent
    PYTHONPATH=. python icl_torch/tools/kernel_bits.py --times change

(times in turns, parent, change, change, parent, in one call; both
trees' times come from this file's inputs).

The script's own directory is first on ``sys.path``, so ``icl_torch``
comes from ``PYTHONPATH``: run the script file by its path, not with
``-m``.
"""

from __future__ import annotations

import json
import sys
import tempfile

import numpy as np
import torch

# phase 9's split (chip_smoke.py): the planted synthetic data at 300-d word
# vectors, trained by the relation and affinity CLIs 64 images a batch
PHASE9_SPLIT = dict(planted=True, emb_dim=300, vocab_size=2000,
                    max_caption_len=32, max_mentions_per_caption=3,
                    max_boxes_per_image=20)
PHASE9_TRAIN_IMAGES = 128
IMAGES_PER_BATCH = 64
NULL_WEIGHT = 0.3            # icl-torch-relation's --null_weight default


BF16_RECURRENCE = "recurrence bf16 "   # the cases of the bf16 recurrence
FAST_DOT = ("grid_head bf16dot ", "affinity_rank bf16dot ")   # the fast dot's
PLAIN = " plain"        # a fast-dot case's plain version: "<case> plain"
F32_GATE = 1e-5         # relative to max(1, max |plain|) (chip_smoke.py)


def bf16_units(first: tuple, second: tuple) -> float:
    """The largest max |first - second| over the tensors, each in bf16
    units of its max |first| (a unit: 2 ** (floor(log2 max) - 7)); a NaN
    counts as infinitely far."""
    worst = 0.0
    for x, y in zip(first, second):
        if not x.numel():
            continue
        x, y = x.float(), y.float()
        unit = 2.0 ** (np.floor(np.log2(max(float(x.abs().max()), 1e-30)))
                       - 7)
        d = (x - y).abs().max().nan_to_num(float("inf"))
        worst = max(worst, float(d) / unit)
    return worst


def plain_gap(got: tuple, plain: tuple) -> tuple[float, float]:
    """(max |got - plain|, the f32 gate 1e-5 * max(1, max |plain|)) over
    a case's tensors."""
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, plain))
    top = max(float(w.float().abs().max()) for w in plain)
    return err, F32_GATE * max(1.0, top)


def one_cell_groups(G: int, A: int, B: int, gen: torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """Weights [G, A, B]: zero but for one cell (row and column drawn from
    ``gen``) in groups 0, 2, 4, ... of four rows, none in the others, so
    the backward kernel's walk lists one cell in some groups and none in
    the rest."""
    groups = torch.arange(0, (A + 3) // 4, 2, device=device)
    n = len(groups)
    rows = (4 * groups + torch.randint(0, 4, (G, n), generator=gen,
                                       device=device)).clamp(max=A - 1)
    cols = torch.randint(0, B, (G, n), generator=gen, device=device)
    w = torch.zeros(G, A, B, device=device)
    w[torch.arange(G, device=device)[:, None], rows, cols] = 1.0
    return w


def device_rows(fn, iters: int) -> list:
    """The profiler's rows (one per kernel name) of the GPU work of iters
    calls of fn()."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.count > 0]


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time per fn() call of a kernel wrapper or its plain
    version, without the host's share.  A profiler window now and then
    loses records of a kernel, or catches one of the call before; so a
    kernel's time per call is its mean recorded time times its launches
    per call (the recorded count over iters, rounded, and at least one:
    a window that kept half the records of a kernel launched once a call
    rounds 0.5 down), kernels seen in fewer than half the calls are left
    out, and a window that kept none is taken again.  Where three windows
    keep none (the profiler traced nothing, as it has on a fresh
    machine), the calls are timed by CUDA events instead, the host's gaps
    between launches included, and a line on stderr says so."""
    for _ in range(3):
        rows = [e for e in device_rows(fn, iters) if 2 * e.count >= iters]
        ms = sum(e.self_device_time_total / e.count
                 * max(1, round(e.count / iters)) for e in rows) / 1e3
        if ms > 0:
            return ms
    print("device_ms: the profiler recorded no kernel in three windows; "
          "timed by CUDA events", file=sys.stderr)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def trained_batches(seed: int = 0) -> dict:
    """{"R": (labels, weights), "A": (labels, weights)}: the grid labels
    (int32 [64, M, N]) and cell weights (f32) of the fullest batch of one
    epoch of phase 9's train split, as the relation and affinity CLIs
    batch it (64 images, their default buckets; relation's weights are
    ``valid * [null_weight, 1, 1, 1][label]``, affinity's ``valid``).  On
    the CPU: the split is written to a temporary directory and read back
    (about 2 s)."""
    from icl_torch.data.embeddings import EmbeddingStore
    from icl_torch.data.imagebatch import AffinityBatcher, RelationBatcher
    from icl_torch.data.pipeline import (load_affinity_dataset,
                                         load_relation_dataset)
    from icl_torch.testing.synth import SynthConfig, generate_dataset

    out = {}
    with tempfile.TemporaryDirectory(prefix="icl_kernel_bits_") as d:
        generate_dataset(d, "train", SynthConfig(
            num_images=PHASE9_TRAIN_IMAGES, seed=seed, **PHASE9_SPLIT))
        emb = EmbeddingStore.load(f"{d}/embeddings.txt")
        for tag, ds, batcher, cw in (
                ("R", load_relation_dataset(d, "train", emb),
                 RelationBatcher(images_per_batch=IMAGES_PER_BATCH,
                                 build_grid=True, with_ids=False),
                 np.array([NULL_WEIGHT, 1.0, 1.0, 1.0], np.float32)),
                ("A", load_affinity_dataset(d, "train", emb),
                 AffinityBatcher(images_per_batch=IMAGES_PER_BATCH,
                                 with_ids=False), None)):
            full = max(batcher.batches(ds, rng=np.random.default_rng(seed)),
                       key=lambda b: int(b.arrays["img_valid"].sum()))
            labels = full.arrays["grid_label"].astype(np.int32)
            weights = full.arrays["grid_valid"].astype(np.float32)
            if cw is not None:
                weights = weights * cw[labels]
            out[tag] = (torch.from_numpy(labels), torch.from_numpy(weights))
    return out


def train_inputs(gen: torch.Generator, dev: torch.device, G: int, A: int,
                 B: int, K: int, O: int, density: float | None = None,
                 batch: tuple | None = None) -> dict:
    """The arguments of K5-K8, rate aside, over one random problem drawn
    from ``gen``: weights at ``density`` (the share of cells of weight >
    0; 0.75 if not given) drawn cell by cell, or, with ``batch`` (labels,
    weights of a real batch, :func:`trained_batches`), that batch's labels
    and weights."""
    X = torch.randn(G, A, K, generator=gen, device=dev)
    Y = torch.randn(G, B, K, generator=gen, device=dev)
    b1 = torch.randn(K, generator=gen, device=dev)
    W2 = torch.randn(K, O, generator=gen, device=dev) / K ** 0.5
    b2 = torch.randn(O, generator=gen, device=dev)
    seeds = torch.randint(0, 2 ** 31 - 1, (G,), generator=gen, device=dev,
                          dtype=torch.int32)
    labels = torch.randint(0, O, (G, A, B), generator=gen, device=dev,
                           dtype=torch.int32)
    draw = torch.rand(G, A, B, generator=gen, device=dev)
    weights = ((draw > 0.25 if density is None else draw < density)
               * torch.where(torch.rand(G, A, B, generator=gen,
                                        device=dev) > 0.5, 1.0, 0.3))
    if batch is not None:
        labels, weights = (t.to(dev).contiguous() for t in batch)
    cot = torch.randn(G, A, B, O, generator=gen, device=dev)
    gl = torch.rand((), generator=gen, device=dev)
    return {"grid_head_train_fwd": (X, Y, b1, W2, b2, seeds),
            "grid_head_train_bwd": (X, Y, b1, W2, seeds, cot),
            "grid_head_train_loss_fwd": (X, Y, b1, W2, b2, seeds, labels,
                                         weights),
            "grid_head_train_loss_bwd": (X, Y, b1, W2, b2, seeds, labels,
                                         weights, gl)}


def timed_cases(gen: torch.Generator, dev: torch.device, batches: dict,
                k_rel: int = 800, k_aff: int = 1024) -> dict:
    """{suffix: (shape, inputs)} of chip_smoke.py's timed K5-K8 cases: the
    relation (R: G=64 A=B=16 K=800 O=4) and affinity (A: G=64 A=16 B=32
    K=1024 O=2) batch shapes at density 0.75 (all four kernels), and on a
    trained batch (``batches``, :func:`trained_batches`; K7 and K8, which
    weight the cells)."""
    cases = {}
    for suffix, tag, (A, B, K, O) in (
            ("", "R", (16, 16, k_rel, 4)),
            (" affinity", "A", (16, 32, k_aff, 2))):
        shape = (IMAGES_PER_BATCH, A, B, K, O)
        cases[suffix] = (shape, train_inputs(gen, dev, *shape))
        got = tuple(batches[tag][1].shape)
        if got != (IMAGES_PER_BATCH, A, B):
            raise RuntimeError(f"the trained {tag} batch is {got}, not "
                               f"{(IMAGES_PER_BATCH, A, B)}")
        inputs = train_inputs(gen, dev, *shape, batch=batches[tag])
        cases[suffix + " on a trained batch"] = (shape, {
            k: v for k, v in inputs.items() if "loss" in k})
    return cases


def times(seed: int = 0, rate: float = 0.5) -> list:
    """[(case, kernel, device ms a call)] of K5-K8 in both modes on
    :func:`timed_cases`' inputs, each call's time and, beside it, each of
    the kernels it launches (K8 launches its forward half, the backward
    and a row sum)."""
    from icl_torch.ops import grid_head_train as ght

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)
    calls = {"grid_head_train_fwd": ght.grid_head_train_fwd,
             "grid_head_train_bwd": ght.grid_head_train_bwd,
             "grid_head_train_loss_fwd": ght.grid_head_train_loss_fwd,
             "grid_head_train_loss_bwd": ght.grid_head_train_loss_bwd}
    out = []
    for suffix, (_, inputs) in timed_cases(gen, dev,
                                           trained_batches(seed)).items():
        for name, args in inputs.items():
            for exact in (True, False):
                case = f"{name}{'' if exact else '_onepass'}{suffix}"
                fn = (lambda f=calls[name], a=args, e=exact: f(*a, rate, e))
                out.append((case, "call", device_ms(fn)))
                out.extend((case, e.key, e.self_device_time_total / e.count
                            / 1e3) for e in device_rows(fn, 20))
    return out


def outputs(seed: int = 0) -> dict:
    """{case: tuple of output tensors} of every entry point."""
    from icl_torch.ops import grid_head_train as ght
    from icl_torch.ops.affinity_rank import (affinity_rank,
                                             affinity_rank_reference)
    from icl_torch.ops.grid_head import grid_head, grid_head_reference
    from icl_torch.ops.lstm_recurrence import lstm_recurrence_fwd

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def head(G, A, B, K, O):
        return (rnd(G, A, K), rnd(G, B, K), rnd(K), rnd(K, O) / K ** 0.5,
                rnd(O))

    onepass = hasattr(ght.grid_head_train_fwd, "onepass")
    out = {}
    for G, A, B, K, O in ((1, 16, 16, 800, 4), (8, 16, 16, 800, 4),
                          (64, 16, 16, 800, 4), (64, 16, 32, 1024, 2),
                          (2, 9, 17, 800, 3), (2, 20, 33, 50, 8),
                          (1, 5, 7, 30, 1)):
        args = head(G, A, B, K, O)
        out[f"grid_head {G} {A} {B} {K} {O}"] = (grid_head(*args),)
        out[f"grid_head bf16dot {G} {A} {B} {K} {O}"] = (
            grid_head(*args, fast_dot=True),)
        out[f"grid_head bf16dot {G} {A} {B} {K} {O}{PLAIN}"] = (
            grid_head_reference(*args, fast_dot=True),)
        seeds = torch.randint(0, 2 ** 31 - 1, (G,), generator=gen,
                              device=dev, dtype=torch.int32)
        labels = torch.randint(0, O, (G, A, B), generator=gen, device=dev,
                               dtype=torch.int32)
        weights = (rnd(G, A, B) > 0).float()
        cot = rnd(G, A, B, O)
        X, Y, b1, W2, b2 = args
        for rate in (0.0, 0.5):
            tag = f"{G} {A} {B} {K} {O} rate {rate}"
            out[f"K5 {tag}"] = (ght.grid_head_train_fwd(*args, seeds, rate),)
            out[f"K6 {tag}"] = ght.grid_head_train_bwd(X, Y, b1, W2, seeds,
                                                       cot, rate)
            out[f"K7 {tag}"] = ght.grid_head_train_loss_fwd(
                *args, seeds, labels, weights, rate)
            out[f"K8 {tag}"] = ght.grid_head_train_loss_bwd(
                *args, seeds, labels, weights, torch.ones((), device=dev),
                rate)
            if onepass:
                out[f"K5 onepass {tag}"] = (ght.grid_head_train_fwd(
                    *args, seeds, rate, False),)
                out[f"K6 onepass {tag}"] = ght.grid_head_train_bwd(
                    X, Y, b1, W2, seeds, cot, rate, False)
                out[f"K7 onepass {tag}"] = ght.grid_head_train_loss_fwd(
                    *args, seeds, labels, weights, rate, False)
                out[f"K8 onepass {tag}"] = ght.grid_head_train_loss_bwd(
                    *args, seeds, labels, weights,
                    torch.ones((), device=dev), rate, False)
    for G, L, B, H in ((2, 32, 64, 200), (2, 32, 512, 200),
                       (1, 16, 1024, 200), (2, 16, 61, 256), (2, 8, 5, 64)):
        lengths = torch.randint(0, L + 1, (B,), generator=gen, device=dev)
        t = torch.arange(L, device=dev)[:, None]
        mask = torch.stack([t < lengths, (L - 1 - t) < lengths])[:G]
        args = (rnd(G, L, B, 4 * H), mask.contiguous(),
                rnd(G, H, 4 * H) / H ** 0.5)
        out[f"recurrence {G} {L} {B} {H}"] = lstm_recurrence_fwd(*args)
        out[f"recurrence {G} {L} {B} {H} residuals"] = lstm_recurrence_fwd(
            *args, residuals=True)
        bf16 = (args[0].bfloat16(), args[1], args[2].bfloat16())
        out[f"recurrence bf16 {G} {L} {B} {H} residuals"] = \
            lstm_recurrence_fwd(*bf16, residuals=True)
    for G in (4, 64):
        valid = rnd(G, 32) > -0.5
        valid[:, 0] = True
        args = head(G, 16, 32, 1024, 2)
        out[f"affinity_rank {G}"] = (affinity_rank(*args, valid),)
        out[f"affinity_rank bf16dot {G}"] = (affinity_rank(
            *args, valid, fast_dot=True),)
        out[f"affinity_rank bf16dot {G}{PLAIN}"] = (affinity_rank_reference(
            *args, valid, 1, True),)
    # cells without a cotangent, which the backward kernel does not walk:
    # K8 with weights zero but for one cell in every other group of four
    # rows, K6 with a cotangent zero on the cells of weight 0
    for G, A, B, K, O in ((2, 17, 20, 1024, 2), (2, 17, 20, 800, 4),
                          (64, 16, 16, 800, 4)):
        args = head(G, A, B, K, O)
        X, Y, b1, W2, b2 = args
        seeds = torch.randint(0, 2 ** 31 - 1, (G,), generator=gen,
                              device=dev, dtype=torch.int32)
        labels = torch.randint(0, O, (G, A, B), generator=gen, device=dev,
                               dtype=torch.int32)
        sparse = one_cell_groups(G, A, B, gen, dev)
        weights = (rnd(G, A, B) > 0.6).float()
        cot = rnd(G, A, B, O) * (weights > 0)[..., None]
        gl = torch.ones((), device=dev)
        for rate in (0.0, 0.5):
            for mode in (("", True), (" onepass", False))[:1 + onepass]:
                tag = f"{mode[0]} {G} {A} {B} {K} {O} rate {rate}"
                out[f"K8 one cell a group{tag}"] = ght.grid_head_train_loss_bwd(
                    *args, seeds, labels, sparse, gl, rate, mode[1])
                out[f"K8 density 0.27{tag}"] = ght.grid_head_train_loss_bwd(
                    *args, seeds, labels, weights, gl, rate, mode[1])
                out[f"K6 zero cotangent at weight 0{tag}"] = \
                    ght.grid_head_train_bwd(X, Y, b1, W2, seeds, cot, rate,
                                            mode[1])
    # the recurrence past 256 units (the 16-block cluster), where the tree
    # takes it; then one unit a block, a ragged last block, and the edge of
    # R on chip
    from icl_torch.ops.lstm_recurrence import MAX_H
    for G, L, B, H in ((2, 32, 64, 300), (2, 8, 17, 512), (2, 8, 13, 8),
                       (2, 8, 13, 9), (2, 16, 13, 201), (1, 8, 9, 368),
                       (1, 8, 9, 369)):
        if H > MAX_H:
            continue
        lengths = torch.randint(0, L + 1, (B,), generator=gen, device=dev)
        t = torch.arange(L, device=dev)[:, None]
        mask = torch.stack([t < lengths, (L - 1 - t) < lengths])[:G]
        args = (rnd(G, L, B, 4 * H), mask.contiguous(),
                rnd(G, H, 4 * H) / H ** 0.5)
        out[f"recurrence {G} {L} {B} {H} residuals"] = lstm_recurrence_fwd(
            *args, residuals=True)
        out[f"recurrence bf16 {G} {L} {B} {H} residuals"] = \
            lstm_recurrence_fwd(args[0].bfloat16(), args[1],
                                args[2].bfloat16(), residuals=True)
    torch.cuda.synchronize()
    return {k: tuple(t.cpu() for t in v) for k, v in out.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--compare"]:
        a, b = (torch.load(p, weights_only=True) for p in argv[1:3])
        differ = [k for k in a if k not in b or len(a[k]) != len(b[k])
                  or not all(torch.equal(x, y) for x, y in zip(a[k], b[k]))]
        # the bf16 recurrence's sum order is its own since h . R went to
        # the tensor cores: its cases are held to the plain version within
        # BF16_REC_ULPS by chip_smoke.py, and only reported here
        changed = {k: bf16_units(a[k], b[k]) for k in differ
                   if k.startswith(BF16_RECURRENCE) and k in b
                   and len(a[k]) == len(b[k])}
        # the fast dot: within the f32 gate of its plain version
        gated = {k: plain_gap(b[k], b[k + PLAIN]) for k in differ
                 if k.startswith(FAST_DOT) and not k.endswith(PLAIN)
                 and k in b and k + PLAIN in b}
        gated = {k: g for k, g in gated.items() if g[0] <= g[1]}
        differ = [k for k in differ if k not in changed and k not in gated]
        new = [k for k in b if k not in a]
        print(f"kernel bits: {len(a) - len(differ) - len(changed) - len(gated)}"
              f" of {len(a)} cases bit-equal; differ: {differ}; {len(new)} "
              f"cases only in the second file: {new}")
        for k, units in changed.items():
            print(f"kernel bits: {k}: changed, held to BF16_REC_ULPS "
                  f"(chip_smoke.py); {units:.2f} bf16 units of max |first| "
                  f"apart")
        for k, (err, gate) in gated.items():
            print(f"kernel bits: {k}: changed, max|d| {err:.3e} from its "
                  f"plain version (the f32 gate {gate:.3e})")
        return 1 if differ else 0
    if argv[:1] == ["--times"]:
        for case, kernel, ms in times():
            print(json.dumps({"tree": argv[1], "case": case,
                              "kernel": kernel, "device_ms": ms}))
        return 0
    torch.save(outputs(), argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
