"""Where a step of the LSTM recurrence kernel spends its cycles.

The recurrence (``icl_torch/csrc/lstm_recurrence.cu``) is one launch of L
dependent steps, and a profiler that sees inside a kernel is not always at
hand.  Built with ``-DICL_LSTM_CLOCKS`` the kernel adds up ``clock64()``
differences per phase for thread 0 of block (0, 0): the next step's loads,
this step's stores and the wait for the peers' h; phase A (the FMAs); the
half block's barrier; phase B (partial sums, gates); the second barrier;
and the push of the new h to the peers.  This script builds that variant beside the plain
one, checks both against the plain PyTorch version, and prints per shape the
time per call (CUDA events over back-to-back launches) of the plain build
and the instrumented build's cycles per step and phase, with the card's
name and power limit.

With ``--bf16`` it does the same for the bf16 mode (``--compute_dtype
bf16``; phase A is then its tensor-core product), holds it to the plain
version within ``BF16_REC_ULPS`` bf16 units of max |plain|, and also times
builds with ``-DICL_LSTM_BF16_BLOCKS=1`` and ``=2``, which run one or two
blocks an SM wherever two fit, beside the plain build, which chooses by
the grid (their bits must agree).
Run with ``PYTHONPATH`` at another tree (the script file by its path, as
``kernel_bits.py``), it measures that tree's kernel on the same inputs.

Usage, on a machine with an NVIDIA GPU of compute capability 9.0::

    python -m icl_torch.tools.lstm_phase_clocks [--bf16] [G,L,B,H ...]
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys

import torch

from icl_torch.ops import _build
from icl_torch.ops.lstm_recurrence import (_ARGTYPES, lstm_recurrence_fwd,
                                           lstm_recurrence_reference)

PHASES = ("loads, stores, wait", "A h.R", "barrier", "B gates",
          "barrier 2", "push")
SHAPES = ((2, 32, 8, 200), (2, 32, 64, 200), (2, 32, 320, 200),
          (2, 32, 512, 200), (1, 16, 1024, 200), (2, 8, 40, 256))
BF16_SHAPES = ((2, 32, 64, 200), (2, 32, 320, 200), (2, 32, 512, 200),
               (1, 16, 1024, 200), (2, 32, 64, 300), (2, 32, 64, 512))
BF16_REC_ULPS = 4   # chip_smoke.py's gate of the bf16 mode, bf16 units


def bf16_units(got, want) -> float:
    """max |got - want| over the tensors, each in bf16 units of its max
    |want| (a unit: 2 ** (floor(log2 max) - 7)): kernel_bits.bf16_units,
    kept here because this script also runs on another tree's icl_torch,
    which may lack it."""
    worst = 0.0
    for g, w in zip(got, want):
        w = w.float()
        top = max(w.abs().max().item(), 1e-30)
        unit = 2.0 ** (math.floor(math.log2(top)) - 7)
        worst = max(worst, (g.float() - w).abs().max().item() / unit)
    return worst


def inputs(G, L, B, H, gen, dev):
    lengths = torch.randint(0, L + 1, (B,), generator=gen, device=dev)
    lengths[0], lengths[-1] = 0, L
    t = torch.arange(L, device=dev)[:, None]
    mask = torch.stack([t < lengths, (L - 1 - t) < lengths])[:G]
    return (torch.randn(G, L, B, 4 * H, generator=gen, device=dev),
            mask.contiguous(),
            torch.randn(G, H, 4 * H, generator=gen, device=dev) / H ** .5)


def event_ms(fn, iters: int = 20) -> float:
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


def library(flag: str, entry: str) -> ctypes.CDLL:
    """The recurrence source built with ``flag``, ``entry`` bound."""
    path, _ = _build.build("lstm_recurrence", (flag,))
    lib = ctypes.CDLL(str(path))
    getattr(lib, entry).argtypes = _ARGTYPES
    return lib


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("lstm_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    bf16 = argv[:1] == ["--bf16"]
    argv = argv[1:] if bf16 else argv
    shapes = [tuple(int(v) for v in a.split(",")) for a in argv] or (
        BF16_SHAPES if bf16 else SHAPES)
    entry = "icl_lstm_recurrence_bf16" if bf16 else "icl_lstm_recurrence_f32"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lib = library("-DICL_LSTM_CLOCKS", entry)
    lib.icl_lstm_recurrence_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    per_sm = {n: library(f"-DICL_LSTM_BF16_BLOCKS={n}", entry)
              for n in ((1, 2) if bf16 else ())}
    clocks = (ctypes.c_longlong * 8)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bad = 0
    for G, L, B, H in shapes:
        x, m, R = inputs(G, L, B, H, gen, dev)
        if bf16:
            x, R = x.bfloat16(), R.bfloat16()
        want = lstm_recurrence_reference(x, m, R, True)
        got = lstm_recurrence_fwd(x, m, R, residuals=True)
        outs = [torch.empty_like(t) for t in want]
        forced = {n: [torch.empty_like(t) for t in want] for n in per_sm}

        def call(lib, outs, what):
            err = getattr(lib, entry)(
                x.data_ptr(), m.data_ptr(), R.data_ptr(), outs[0].data_ptr(),
                outs[1].data_ptr(), outs[2].data_ptr(), outs[3].data_ptr(),
                G, L, B, H, dev.index or 0, stream)
            _build.check(err, f"lstm_recurrence ({what} build)")

        def probe():
            call(lib, outs, "clocks")

        probe()
        for n, lib_n in per_sm.items():
            call(lib_n, forced[n], f"{n} blocks an SM")
        torch.cuda.synchronize()
        if bf16:
            err = bf16_units(got, want)
            same = all(torch.equal(a, b) for o in (outs, *forced.values())
                       for a, b in zip(got, o))
            bad += not (err <= BF16_REC_ULPS and same)
        else:
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, outs))
            bad += not (err <= 1e-5 and same)
        ms = event_ms(lambda: lstm_recurrence_fwd(x, m, R))
        ms_res = event_ms(lambda: lstm_recurrence_fwd(x, m, R, residuals=True))
        ms_probe = event_ms(probe)
        ms_forced = {n: event_ms(lambda n=n: call(per_sm[n], forced[n],
                                                  f"{n} blocks an SM"))
                     for n in per_sm}
        lib.icl_lstm_recurrence_clocks(clocks, 1)
        iters = 20
        for _ in range(iters):
            probe()
        torch.cuda.synchronize()
        lib.icl_lstm_recurrence_clocks(clocks, 1)
        per = [clocks[i] / iters / L for i in range(len(PHASES))]
        print(f"{'bf16' if bf16 else 'f32'} G={G} L={L} B={B} H={H}: "
              + (f"max|kernel - plain| {err:.2f} bf16 units of max|plain| "
                 f"(gate {BF16_REC_ULPS}), clocks and 1/2-block builds "
                 if bf16 else f"max|kernel - plain| {err:.2e}, clocks build ")
              + f"bitwise equal {same}; {ms:.4f} ms a call, "
              f"{ms_res:.4f} ms with residuals ({ms_probe:.4f} ms in the "
              f"clocks build"
              + "".join(f", {ms:.4f} ms with residuals at {n} block(s) an SM"
                        for n, ms in ms_forced.items())
              + "); cycles a step "
              f"{sum(per):.0f}: "
              + ", ".join(f"{n} {c:.0f}" for n, c in zip(PHASES, per))
              + f" ({card})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
