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

Usage, on a machine with an NVIDIA GPU of compute capability 9.0::

    python -m icl_torch.tools.lstm_phase_clocks [G,L,B,H ...]
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from icl_torch.ops import _build
from icl_torch.ops.lstm_recurrence import (_ARGTYPES, lstm_recurrence_fwd,
                                           lstm_recurrence_reference)

PHASES = ("loads, stores, wait", "A fma", "barrier", "B gates",
          "barrier 2", "push")
SHAPES = ((2, 32, 8, 200), (2, 32, 64, 200), (2, 32, 320, 200),
          (2, 32, 512, 200), (1, 16, 1024, 200), (2, 8, 40, 256))


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


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("lstm_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    shapes = [tuple(int(v) for v in a.split(",")) for a in argv] or SHAPES
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    path, _ = _build.build("lstm_recurrence", ("-DICL_LSTM_CLOCKS",))
    lib = ctypes.CDLL(str(path))
    lib.icl_lstm_recurrence_f32.argtypes = _ARGTYPES
    lib.icl_lstm_recurrence_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    clocks = (ctypes.c_longlong * 8)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bad = 0
    for G, L, B, H in shapes:
        x, m, R = inputs(G, L, B, H, gen, dev)
        want = lstm_recurrence_reference(x, m, R, True)
        got = lstm_recurrence_fwd(x, m, R, residuals=True)
        outs = [torch.empty_like(t) for t in want]

        def probe():
            err = lib.icl_lstm_recurrence_f32(
                x.data_ptr(), m.data_ptr(), R.data_ptr(), outs[0].data_ptr(),
                outs[1].data_ptr(), outs[2].data_ptr(), outs[3].data_ptr(),
                G, L, B, H, dev.index or 0, stream)
            _build.check(err, "lstm_recurrence (clocks build)")

        probe()
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, outs))
        bad += not (err <= 1e-5 and same)
        ms = event_ms(lambda: lstm_recurrence_fwd(x, m, R))
        ms_res = event_ms(lambda: lstm_recurrence_fwd(x, m, R, residuals=True))
        ms_probe = event_ms(probe)
        lib.icl_lstm_recurrence_clocks(clocks, 1)
        iters = 20
        for _ in range(iters):
            probe()
        torch.cuda.synchronize()
        lib.icl_lstm_recurrence_clocks(clocks, 1)
        per = [clocks[i] / iters / L for i in range(len(PHASES))]
        print(f"G={G} L={L} B={B} H={H}: max|kernel - plain| {err:.2e}, "
              f"clocks build bitwise equal {same}; {ms:.4f} ms a call, "
              f"{ms_res:.4f} ms with residuals ({ms_probe:.4f} ms in the "
              f"clocks build); cycles a step "
              f"{sum(per):.0f}: "
              + ", ".join(f"{n} {c:.0f}" for n, c in zip(PHASES, per))
              + f" ({card})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
