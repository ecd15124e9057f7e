"""Fused M x M grid head: ``out[g,a,b,:] = relu(X[g,a]+Y[g,b]+b1) @ W2 + b2``.

Counterpart of ``icl/ops/grid_head.py``.  Because concatenation into a Dense
layer distributes over the weight, the relation head over every ordered
mention pair ``relu([m_a; m_b] @ W1 + b1) @ W2 + b2`` equals
``relu(X[a] + Y[b] + b1) @ W2 + b2`` with ``X = m @ W1_top`` and
``Y = m @ W1_bot`` projected once per mention.

* :func:`grid_head_reference` is the plain PyTorch version; it materialises
  the [G, A, B, K] activation.
* ``fast_dot=True`` is the bf16 mode of both (the reference's ``fast_dot``
  under ``--compute_dtype bf16``): the activation ``relu((X + b1) + Y)``,
  added in f32 in that order, and W2 are rounded to bf16, and the dot
  sums their exact products in f32.  Inputs and output stay f32.  The CUDA
  entry point is ``icl_grid_head_bf16dot``; its launches count in
  ``grid_head.bf16dot.launches``.
* :func:`grid_head` is the wrapper: for CUDA tensors it launches the
  hand-written kernel ``icl_torch/csrc/grid_head.cu`` (the [A, B, K]
  activation never leaves the registers); for CPU tensors it runs the plain
  version.  A CUDA call that the kernel cannot take raises.
* :func:`launch_plan` picks how many warps of a block split K for a call,
  the launch's one free choice, and tells the form (16-byte or scalar
  loads) and the grid that follow from the operands.  The training forward
  kernels (``grid_head_train``) and the box ranking (``affinity_rank``)
  share the tile routine (``icl_torch/csrc/grid_head_tile.cuh``) and this
  plan.
* :func:`check_no_grad`: the predict kernels have no backward, so a CUDA
  call that autograd would record raises :class:`KernelNoGradError`.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple

import torch

from icl_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
MAX_O = 8           # kMaxO in csrc/grid_head_tile.cuh
MAX_WARPS = 8       # kMaxWarps there: column tiles x k slices of a block
COL_TILES = 4       # kColTiles there: column tiles a block without a K split
RANK_COL_WARPS = 8  # kRankColWarps in csrc/affinity_rank.cu
RANK_WARPS = 16     # kRankWarps there: column tiles x k slices of a block
_FILL_WARPS = 1056  # 8 warps on each of the H100's 132 SMs


class HeadPlan(NamedTuple):
    """How a forward grid-head kernel is launched (see :func:`launch_plan`).
    ``ksplit`` goes to the kernel's entry point; ``vec`` and ``blocks`` are
    what ``plan_launch`` in the header derives from it and the operands."""
    vec: int         # 1: 16-byte loads, 4 k a lane; 0: scalar loads
    ksplit: int      # warps of a block that split K between them
    blocks: int      # the launch grid; the loss kernel writes a row a block


def aligned16(*tensors: torch.Tensor) -> bool:
    """Every tensor starts on a 16-byte boundary (a view with a storage
    offset may not)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


class KernelNoGradError(RuntimeError):
    """A forward-only CUDA kernel was called where autograd would record
    it: its result would carry no graph."""


def wants_grad(grad_enabled: bool, requires_grad) -> bool:
    """Autograd would record a call: grad mode is on and an input requires
    grad."""
    return bool(grad_enabled) and any(requires_grad)


def check_no_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise :class:`KernelNoGradError` where a kernel without a backward
    would be recorded by autograd (its plain version on the CPU is
    differentiable; the kernel's result is not)."""
    if wants_grad(torch.is_grad_enabled(),
                  (t.requires_grad for t in tensors)):
        raise KernelNoGradError(
            f"{what}: the CUDA kernel has no backward, and an input requires "
            f"grad; call it under torch.inference_mode() or torch.no_grad() "
            f"(training goes through grid_head_train / grid_head_train_loss)")


def launch_plan(G: int, A: int, B: int, K: int, O: int, aligned: bool,
                whole_rows: bool = False) -> HeadPlan:
    """The form of the tile routine for a [G, A, B] grid of depth K.

    A warp owns a tile of cells, 4 x 4 when the loads are 16 bytes wide and
    O is 2 or 4, else 2 x 2, and its lanes split K in chunks of 4 (or 1)
    consecutive k, 32 chunks a pass.  The 16-byte form needs ``aligned``
    operands (X, Y, b1, W2) and K % 4 == 0.  A grid with fewer tiles than
    fill the card splits K over up to 8 warps of a block (at most one pass
    each), one column tile a block; a large one has no split and up to 4
    column tiles a block.

    ``whole_rows`` (the box ranking: one output column, a softmax over each
    row of the grid): tiles are 4 x 4 in both forms, and a block owns the
    whole rows of its row tile: up to 8 column tiles side by side, taking
    the rest in turns, times the K split, at most 16 warps.
    """
    vec = int(aligned and K % 4 == 0)
    tile = 4 if whole_rows or (vec and O in (2, 4)) else 2
    row_tiles, col_tiles = -(-A // tile), -(-B // tile)
    tiles = G * row_tiles * col_tiles
    passes = -(-K // (32 * (4 if vec else 1)))
    side = min(col_tiles, RANK_COL_WARPS)
    most = RANK_WARPS // side if whole_rows else MAX_WARPS
    ksplit = 1      # from half the fill on, a split only adds reductions
    if 2 * tiles < _FILL_WARPS:
        ksplit = min(passes, most, -(-_FILL_WARPS // tiles))
    if whole_rows:
        return HeadPlan(vec, ksplit, G * row_tiles)
    col_warps = 1 if ksplit > 1 else min(col_tiles, COL_TILES)
    return HeadPlan(vec, ksplit, G * row_tiles * -(-col_tiles // col_warps))


def grid_head_reference(X: torch.Tensor, Y: torch.Tensor, b1: torch.Tensor,
                        W2: torch.Tensor, b2: torch.Tensor,
                        fast_dot: bool = False) -> torch.Tensor:
    """Plain version: [G,A,K], [G,B,K] -> [G,A,B,O] via the full grid.

    ``fast_dot``: b1 is folded into X first, as the reference's kernels and
    the CUDA tile routine add it (the order of the f32 adds decides which
    cells round to which bf16 value); then h and W2 are rounded to bf16 and
    contracted in f32."""
    if not fast_dot:
        h = torch.relu(X[:, :, None, :] + Y[:, None, :, :] + b1)
        return torch.einsum("gabk,ko->gabo", h, W2) + b2
    h = torch.relu((X + b1)[:, :, None, :] + Y[:, None, :, :])
    return torch.einsum("gabk,ko->gabo", _bf16_values(h),
                        _bf16_values(W2)) + b2


def _bf16_values(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), as f32."""
    return t.to(torch.bfloat16).to(t.dtype)


def grid_head(X: torch.Tensor, Y: torch.Tensor, b1: torch.Tensor,
              W2: torch.Tensor, b2: torch.Tensor,
              fast_dot: bool = False) -> torch.Tensor:
    """Same contract as :func:`grid_head_reference`; the kernel on CUDA
    (``fast_dot``: its bf16 mode).

    An empty grid (G, A or B = 0) returns zeros without a launch.
    """
    if X.device.type == "cpu":
        return grid_head_reference(X, Y, b1, W2, b2, fast_dot)
    if X.device.type != "cuda":
        raise ValueError(f"grid_head: unsupported device {X.device}")
    G, A, K = X.shape
    B = Y.shape[1]
    O = W2.shape[1]
    _check(X, Y, b1, W2, b2, G, A, B, K, O)
    check_no_grad("grid_head", X, Y, b1, W2, b2)
    out = torch.empty((G, A, B, O), dtype=torch.float32, device=X.device)
    if G == 0 or A == 0 or B == 0:
        return out.zero_()
    plan = launch_plan(G, A, B, K, O, aligned16(X, Y, b1, W2))
    entry = "icl_grid_head_bf16dot" if fast_dot else "icl_grid_head_f32"
    fn = getattr(_build.load("grid_head", entry, _ARGTYPES), entry)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = fn(X.data_ptr(), Y.data_ptr(), b1.data_ptr(), W2.data_ptr(),
             b2.data_ptr(), out.data_ptr(), G, A, B, K, O, plan.ksplit,
             X.device.index, stream)
    _build.check(err, "grid_head")
    (grid_head.bf16dot if fast_dot else grid_head).launches += 1
    return out


grid_head.launches = 0   # kernel launches since the last reset
grid_head.bf16dot = SimpleNamespace(launches=0)   # those of the bf16 mode


def _check(X, Y, b1, W2, b2, G, A, B, K, O) -> None:
    tensors = {"X": X, "Y": Y, "b1": b1, "W2": W2, "b2": b2}
    for name, t in tensors.items():
        if t.device != X.device:
            raise ValueError(f"grid_head: {name} on {t.device}, X on "
                             f"{X.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"grid_head: {name} is {t.dtype}, needs float32")
        if not t.is_contiguous():
            raise ValueError(f"grid_head: {name} is not contiguous")
    want = {"Y": (G, B, K), "b1": (K,), "W2": (K, O), "b2": (O,)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"grid_head: {name} has shape "
                             f"{tuple(tensors[name].shape)}, needs {shape}")
    if not 1 <= O <= MAX_O:
        raise ValueError(f"grid_head: O={O} outside 1..{MAX_O}")
    check_grid_size("grid_head", G, A, B, K)


def check_grid_size(what: str, G: int, A: int, B: int, K: int) -> None:
    """The tile routine indexes one image's X and Y with 32-bit offsets and
    launches at most G * A * B blocks."""
    if max(A, B) * K >= 2 ** 31 or G * A * B >= 2 ** 31:
        raise ValueError(f"{what}: G={G}, A={A}, B={B}, K={K} exceed the "
                         f"kernel's 32-bit offsets")
