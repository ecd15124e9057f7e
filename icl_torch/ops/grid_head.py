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
  sums their exact products in f32.  Inputs and output stay f32.  On CUDA
  it runs on the tensor cores (``icl_grid_head_bf16dot``, the ``mma.sync``
  routine of ``csrc/grid_head_tile.cuh``, launched as :func:`dot_plan`
  says) where the grid holds enough work, else in the FMA form the f32
  kernel's launch shape takes (``icl_grid_head_bf16fma``): ``dot_plan``
  says which.  Both count in ``grid_head.bf16dot.launches``, those on the
  tensor cores also in ``grid_head.bf16dot.mma_launches``.
* :func:`grid_head` is the wrapper: for CUDA tensors it launches the
  hand-written kernel ``icl_torch/csrc/grid_head.cu`` (the [A, B, K]
  activation never leaves the registers); for CPU tensors it runs the plain
  version.  A CUDA call that the kernel cannot take raises.
* :func:`launch_plan` picks how many warps of a block split K for a call,
  the launch's one free choice, and tells the form (16-byte or scalar
  loads) and the grid that follow from the operands.  The training forward
  kernels (``grid_head_train``) and the box ranking (``affinity_rank``)
  share the tile routine (``icl_torch/csrc/grid_head_tile.cuh``) and this
  plan; the fast dot of both has its own, :func:`dot_plan`.
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
DOT_MENTIONS = 8    # kDotMentions in csrc/grid_head_tile.cuh: a warp tile's
DOT_WARPS = 8       # kDotWarps there: warps a block of the fast dot
DOT_K = 16          # kDotK there: k a chunk, one mma deep
DOT_STAGES = 4      # kDotStages there: chunks in a warp's cp.async ring
DOT_SMEM = 227 * 1024          # kDotSmem: a block's shared memory
# the fast dot's work, G A B K (4 + O), from which the tensor cores take a
# call (fastdot_times.py --sizes, H100: relation G=32 / G=48 and affinity
# and ranking G=16 / G=32 lie on either side)
DOT_WORK = 1 << 26


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


class DotPlan(NamedTuple):
    """How the fast dot (the bf16 mode of K1/K2 and K9) is launched (see
    :func:`dot_plan`).  ``mma`` False: the FMA form, with
    :func:`launch_plan`'s launch; else ``ksplit`` goes to the tensor-core
    entry point and the rest is what ``plan_dot`` in the header derives."""
    mma: bool        # the tensor cores (else the FMA form)
    vec: int         # 1: 16-byte loads of X, Y and b1; 0: 4-byte loads
    bt: int          # boxes an m-tile: 16, or 8 where B <= 8
    ksplit: int      # warps of a block that split K between them
    tasks: int       # warp tiles (of boxes) side by side in a block
    blocks: int      # the launch grid
    threads: int     # a block's threads
    smem: int        # a block's shared memory, bytes


def dot_plan(G: int, A: int, B: int, K: int, O: int, aligned: bool,
             whole_rows: bool = False) -> DotPlan:
    """The launch of the fast dot for a [G, A, B] grid of depth K.

    On the tensor cores (``plan_dot`` in ``csrc/grid_head_tile.cuh``): a
    warp tile is 8 mentions x 16 boxes (8 m-tiles), or 8 x 8 where B <= 8
    (4 m-tiles of two mentions); its lanes take 16 k a chunk, one ``mma``
    an m-tile.  A block is one group of 8 mentions of an image with all
    its boxes: up to 8 tiles side by side, the rest in turns, times the K
    split, at most 8 warps; a grid with fewer tiles than fill the card
    splits K.  The 16-byte loads need ``aligned`` X, Y and b1 and K % 4 ==
    0 (W2 is read once a block, in any alignment).  Shared memory: W2's
    bf16 fragments, X + b1 of the group, a ring of 4 chunks of Y a warp
    (the split's sums reuse it) and, for the box ranking (``whole_rows``),
    the group's scores.

    The tensor cores take a call whose work, G A B K (4 + O), reaches
    ``DOT_WORK`` and whose block fits ``DOT_SMEM``; below it a block's
    set-up (one round of loads for X + b1 and W2, then the ring's) costs
    more than the FMA form's whole call, which takes the rest.
    """
    vec = int(aligned and K % 4 == 0)
    bt = 8 if B <= 8 else 16
    mentions = DOT_MENTIONS
    row_groups, col_tiles = -(-A // mentions), -(-B // bt)
    chunks = -(-K // DOT_K)
    tiles = G * row_groups * col_tiles
    tasks = min(col_tiles, DOT_WARPS)
    ksplit = 1      # from half the fill on, a split only adds reductions
    if 2 * tiles < _FILL_WARPS:
        ksplit = min(chunks, DOT_WARPS // tasks, -(-_FILL_WARPS // tiles))
    warps = tasks * ksplit
    ring = DOT_STAGES * bt * DOT_K           # floats a warp; the split's
    ring = max(ring, (8 if bt == 16 else 4) * 4 * 32)   # sums reuse it
    smem = (chunks * 32 * 8 + mentions * chunks * DOT_K * 4
            + warps * ring * 4 + (mentions * B * 4 if whole_rows else 0))
    mma = G * A * B * K * (4 + O) >= DOT_WORK and smem <= DOT_SMEM
    return DotPlan(mma, vec, bt, ksplit, tasks, G * row_groups, 32 * warps,
                   smem)


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
    if fast_dot:
        mma = dot_plan(G, A, B, K, O, aligned16(X, Y, b1)).mma
        _fast_dot(X, Y, b1, W2, b2, out, mma)
        grid_head.bf16dot.launches += 1
        grid_head.bf16dot.mma_launches += mma
        return out
    plan = launch_plan(G, A, B, K, O, aligned16(X, Y, b1, W2))
    _launch("icl_grid_head_f32", X, Y, b1, W2, b2, out, plan.ksplit)
    grid_head.launches += 1
    return out


def _fast_dot(X, Y, b1, W2, b2, out, mma: bool) -> None:
    """The fast dot's launch in the form given: the tensor cores, or the
    FMA form with :func:`launch_plan`'s split."""
    (G, A, K), B, O = X.shape, Y.shape[1], W2.shape[1]
    if mma:
        plan = dot_plan(G, A, B, K, O, aligned16(X, Y, b1))
        _launch("icl_grid_head_bf16dot", X, Y, b1, W2, b2, out, plan.ksplit)
    else:
        plan = launch_plan(G, A, B, K, O, aligned16(X, Y, b1, W2))
        _launch("icl_grid_head_bf16fma", X, Y, b1, W2, b2, out, plan.ksplit)


def _launch(entry, X, Y, b1, W2, b2, out, ksplit) -> None:
    (G, A, K), B, O = X.shape, Y.shape[1], W2.shape[1]
    fn = getattr(_build.load("grid_head", entry, _ARGTYPES), entry)
    err = fn(X.data_ptr(), Y.data_ptr(), b1.data_ptr(), W2.data_ptr(),
             b2.data_ptr(), out.data_ptr(), G, A, B, K, O, ksplit,
             X.device.index, torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(err, "grid_head")


grid_head.launches = 0   # kernel launches since the last reset
# those of the bf16 mode, and of them those on the tensor cores
grid_head.bf16dot = SimpleNamespace(launches=0, mma_launches=0)


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
