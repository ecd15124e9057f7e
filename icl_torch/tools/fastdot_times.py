"""Device ms of the fast dot, the bf16 mode of the grid head (K1/K2,
``icl_grid_head_bf16dot``) and of the box ranking (K9,
``icl_affinity_rank_bf16dot``), beside their f32 modes.

A GPU tool, two measurements:

* ``--splits``: the tensor-core kernels at every K split they take, at
  chip_smoke.py's shapes, beside the split
  :func:`~icl_torch.ops.grid_head.dot_plan` picks;
* ``--sizes <label>``: the public wrappers (``grid_head``,
  ``affinity_rank``) in both modes over the grid sizes the command lines
  and the server feed them, G images of the relation (16 x 16 mentions,
  K = 800, O = 4; and a batch at K = 792) and affinity (16 phrases x 32
  boxes, K = 1024, O = 2) shapes.  It runs on any tree's ``icl_torch``: run this file by its path
  with ``PYTHONPATH`` at the tree, parent, change, change, parent, in one
  call, as kernel_bits.py's ``--times``::

      PYTHONPATH=_archive/parent python icl_torch/tools/fastdot_times.py --sizes parent
      PYTHONPATH=. python icl_torch/tools/fastdot_times.py --sizes change

One JSON line a measurement, the card's name and power limit first.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

# (name, G, A, B, K, O): the relation and affinity shapes chip_smoke.py
# times, a served relation request, and a K no multiple of 16
HEADS = (("relation G=64", 64, 16, 16, 800, 4),
         ("relation G=8", 8, 16, 16, 800, 4),
         ("relation G=1", 1, 16, 16, 800, 4),
         ("relation G=64 K=792", 64, 16, 16, 792, 4),
         ("affinity G=64", 64, 16, 32, 1024, 2))
RANKS = (("rank G=64", 64, 16, 32, 1024), ("rank G=4", 4, 16, 32, 1024))
SIZES = {"relation": ((1, 2, 4, 8, 16, 24, 32, 48, 64, 128), 16, 16, 800, 4),
         "relation K=792": ((64,), 16, 16, 792, 4),
         "affinity": ((1, 4, 8, 16, 32, 64), 16, 32, 1024, 2),
         "rank": ((1, 4, 8, 16, 32, 64), 16, 32, 1024, 2)}


def _inputs(gen, dev, G, A, B, K, O, rank):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    args = (rnd(G, A, K), rnd(G, B, K), rnd(K), rnd(K, O) / K ** 0.5, rnd(O))
    return (*args, rnd(G, B) > -0.5) if rank else args


def splits(gen, dev) -> None:
    from icl_torch.ops import _build
    from icl_torch.ops.affinity_rank import _ARGTYPES as RANK_ARGTYPES
    from icl_torch.ops.grid_head import (_ARGTYPES, DOT_WARPS, aligned16,
                                         dot_plan)
    from icl_torch.tools.kernel_bits import device_ms

    stream = torch.cuda.current_stream().cuda_stream
    for name, G, A, B, K, O in HEADS + tuple(
            (n, G, A, B, K, 2) for n, G, A, B, K in RANKS):
        rank = name.startswith("rank")
        args = _inputs(gen, dev, G, A, B, K, O, rank)
        X, Y, b1, W2, b2 = (t.data_ptr() for t in args[:5])
        plan = dot_plan(G, A, B, K, O, aligned16(*args[:3]), rank)
        if rank:
            out = torch.empty((G, A, B), device=dev)
            fn = _build.load("affinity_rank", "icl_affinity_rank_bf16dot",
                             RANK_ARGTYPES).icl_affinity_rank_bf16dot
        else:
            out = torch.empty((G, A, B, O), device=dev)
            fn = _build.load("grid_head", "icl_grid_head_bf16dot",
                             _ARGTYPES).icl_grid_head_bf16dot
        for ksplit in range(1, DOT_WARPS // plan.tasks + 1):
            def call(ksplit=ksplit):
                tail = (G, A, B, K, O, 1, ksplit) if rank else (
                    G, A, B, K, O, ksplit)
                head = (X, Y, b1, W2, b2) + ((args[5].data_ptr(),)
                                             if rank else ())
                _build.check(fn(*head, out.data_ptr(), *tail, dev.index or 0,
                                stream), "fastdot_times")
            print(json.dumps({"case": name, "ksplit": ksplit,
                              "planned": ksplit == plan.ksplit,
                              "device_ms": device_ms(call)}))


def sizes(gen, dev, label: str) -> None:
    from icl_torch.ops.affinity_rank import affinity_rank
    from icl_torch.ops.grid_head import grid_head
    from icl_torch.tools.kernel_bits import device_ms

    for kind, (Gs, A, B, K, O) in SIZES.items():
        rank = kind == "rank"
        for G in Gs:
            args = _inputs(gen, dev, G, A, B, K, O, rank)
            fn = affinity_rank if rank else grid_head
            for fast in (True, False):
                print(json.dumps({
                    "tree": label, "case": f"{kind} G={G}", "mode":
                    "bf16" if fast else "f32", "device_ms": device_ms(
                        lambda: fn(*args, fast_dot=fast))}))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("fastdot_times: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        if argv[:1] == ["--sizes"]:
            sizes(gen, dev, argv[1])
        else:
            splits(gen, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
