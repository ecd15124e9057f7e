"""Two measuring kernels beside the grid head (``csrc/head_probes.cu``).

* :func:`empty_launch` launches a kernel that does nothing: its device time
  is the floor under every launch, against which the served grid-head calls
  (a few hundred nanoseconds of bytes and operations) are read.
* :func:`hash_kept` runs the dropout hash of the grid-head kernels alone
  over every element of a ``[G, A, B, K]`` grid and returns, per cell, how
  many elements the mask keeps.  Its time is what the hash's ten 32-bit
  integer operations an element cost on the card, which settles the rate
  the grid-head bounds give them (``chip_smoke.py``, PERF.md).  The counts
  equal ``dropout_keep_mask(...).sum(-1)``, which is how the probe is held
  to the mask the kernels and the plain versions share.

No path of the port calls either.  Usage, on a machine with an NVIDIA GPU
of compute capability 9.0::

    python -m icl_torch.tools.head_probes
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from icl_torch.ops import _build
from icl_torch.ops.grid_head_train import _keep_threshold, dropout_keep_mask

HASH_INT_OPS = 10    # xor; 2 x (shift, xor, multiply); shift, xor; compare
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32


def empty_launch(device: torch.device) -> None:
    """One launch of a kernel that does nothing, on the current stream."""
    lib = _build.load("head_probes", "icl_probe_empty", [_I, _P])
    err = lib.icl_probe_empty(device.index or 0,
                              torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "head_probes.empty_launch")


def hash_kept(seeds: torch.Tensor, A: int, B: int, K: int,
              rate: float) -> torch.Tensor:
    """seeds int32[G] on a CUDA device -> int32 [G, A, B]: per cell, the
    number of hidden units the dropout mask keeps."""
    if seeds.device.type != "cuda" or seeds.dtype != torch.int32:
        raise ValueError("hash_kept: seeds must be int32 on a CUDA device")
    G = seeds.shape[0]
    kept = torch.empty((G, A, B), dtype=torch.int32, device=seeds.device)
    lib = _build.load("head_probes", "icl_probe_hash_u32",
                      [_P, _P, _I, _I, _I, _I, _U, _I, _P])
    err = lib.icl_probe_hash_u32(
        seeds.contiguous().data_ptr(), kept.data_ptr(), G, A, B, K,
        _keep_threshold(rate), seeds.device.index or 0,
        torch.cuda.current_stream(seeds.device).cuda_stream)
    _build.check(err, "head_probes.hash_kept")
    return kept


def event_ms(fn, iters: int = 200) -> float:
    """Mean time of fn() over back-to-back calls, by CUDA events."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("head_probes: needs an NVIDIA GPU")
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"empty kernel: {event_ms(lambda: empty_launch(dev)):.4f} ms per "
          f"back-to-back launch ({card})")
    for G, A, B, K in ((64, 16, 16, 800), (64, 16, 32, 1024),
                       (512, 32, 32, 1024)):
        seeds = torch.arange(1, G + 1, dtype=torch.int32, device=dev)
        kept = hash_kept(seeds, A, B, K, 0.5)
        want = dropout_keep_mask(seeds[:2], A, B, K, 0.5).sum(-1)
        if not torch.equal(kept[:2].long(), want):
            print("hash probe disagrees with dropout_keep_mask")
            return 1
        ms = event_ms(lambda: hash_kept(seeds, A, B, K, 0.5))
        n = G * A * B * K
        print(f"hash only G={G} A={A} B={B} K={K}: {ms:.4f} ms per call, "
              f"{n * HASH_INT_OPS / ms / 1e9:.2f} T integer operations/s "
              f"({card})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
