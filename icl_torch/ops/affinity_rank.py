"""Box ranking (K9): the per-image masked softmax of the affinity logit.

Counterpart of ``icl/ops/affinity_rank.py``.  For each image g and mention
a, over the image's candidate boxes::

    s[g,a,b]    = (relu(X[g,a] + Y[g,b] + b1) @ W2 + b2)[affinity_col]
    rank[g,a,:] = softmax_b(s[g,a,:])  masked to box_valid[g]

Invalid boxes get exactly 0; an image with no valid box gets zeros.

* :func:`affinity_rank_reference` is the plain PyTorch version: the grid
  head's plain version, then the model's :func:`~icl_torch.models.affinity.
  rank_boxes`, so the masking convention has one source.  It materialises
  the [G, A, B, K] activation.
* :func:`affinity_rank` is the wrapper: for CUDA tensors it launches the
  hand-written kernel ``icl_torch/csrc/affinity_rank.cu`` (the grid head's
  tile routine at one output column, a block owning whole rows of the
  ranking; only the [G, A, B] ranking reaches device memory) and counts the
  launch in ``affinity_rank.launches``; for CPU tensors it runs the plain
  version.  A CUDA call that the kernel cannot take raises, as does one
  that autograd would record (the kernel has no backward).
* ``fast_dot=True`` is the bf16 mode of both: the scores are the grid
  head's fast-dot logits (:func:`~icl_torch.ops.grid_head.
  grid_head_reference`), which the reference both writes and ranks under
  ``--compute_dtype bf16``; the CUDA entry point is
  ``icl_affinity_rank_bf16dot`` on the tensor cores (the grid head's
  ``mma.sync`` routine in its column form) where
  :func:`~icl_torch.ops.grid_head.dot_plan` says so, else
  ``icl_affinity_rank_bf16fma`` (the FMA form in the f32 kernel's launch
  shape); both count in ``affinity_rank.bf16dot.launches``, those on the
  tensor cores also in ``affinity_rank.bf16dot.mma_launches``.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from icl_torch.ops import _build
from icl_torch.ops.grid_head import (aligned16, check_grid_size,
                                     check_no_grad, dot_plan,
                                     grid_head_reference, launch_plan)

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_SMEM = 227 * 1024   # a block's shared memory


def affinity_rank_reference(X: torch.Tensor, Y: torch.Tensor,
                            b1: torch.Tensor, W2: torch.Tensor,
                            b2: torch.Tensor, box_valid: torch.Tensor,
                            affinity_col: int = 1,
                            fast_dot: bool = False) -> torch.Tensor:
    """Plain version: [G,A,K], [G,B,K], [G,B] bool -> [G,A,B]."""
    from icl_torch.models.affinity import rank_boxes

    return rank_boxes(grid_head_reference(X, Y, b1, W2, b2, fast_dot),
                      box_valid, affinity_col=affinity_col)


def affinity_rank(X: torch.Tensor, Y: torch.Tensor, b1: torch.Tensor,
                  W2: torch.Tensor, b2: torch.Tensor, box_valid: torch.Tensor,
                  affinity_col: int = 1,
                  fast_dot: bool = False) -> torch.Tensor:
    """Same contract as :func:`affinity_rank_reference`; the kernel on CUDA
    (``fast_dot``: its bf16 mode).

    An empty grid (G, A or B = 0) returns zeros without a launch.
    """
    if X.device.type == "cpu":
        return affinity_rank_reference(X, Y, b1, W2, b2, box_valid,
                                       affinity_col, fast_dot)
    G, A, B, K, O = _check(X, Y, b1, W2, b2, box_valid, affinity_col)
    check_no_grad("affinity_rank", X, Y, b1, W2, b2)
    out = torch.empty((G, A, B), dtype=torch.float32, device=X.device)
    if out.numel() == 0:
        return out
    mma = fast_dot and dot_plan(G, A, B, K, O, aligned16(X, Y, b1),
                                whole_rows=True).mma
    _launch(X, Y, b1, W2, b2, box_valid, out, affinity_col,
            "mma" if mma else "fma" if fast_dot else "f32")
    (affinity_rank.bf16dot if fast_dot else affinity_rank).launches += 1
    affinity_rank.bf16dot.mma_launches += mma
    return out


def _launch(X, Y, b1, W2, b2, box_valid, out, col, form: str) -> None:
    """One launch of the form given: ``f32``, or the fast dot's ``mma``
    (the tensor cores, :func:`~icl_torch.ops.grid_head.dot_plan`'s split)
    or ``fma`` (the f32 kernel's launch shape)."""
    (G, A, K), B, O = X.shape, Y.shape[1], W2.shape[1]
    if form == "mma":
        ksplit = dot_plan(G, A, B, K, O, aligned16(X, Y, b1), True).ksplit
    else:
        ksplit = launch_plan(G, A, B, K, O, aligned16(X, Y, b1, W2),
                             whole_rows=True).ksplit
    entry = {"f32": "icl_affinity_rank_f32", "mma": "icl_affinity_rank_bf16dot",
             "fma": "icl_affinity_rank_bf16fma"}[form]
    fn = getattr(_build.load("affinity_rank", entry, _ARGTYPES), entry)
    err = fn(X.data_ptr(), Y.data_ptr(), b1.data_ptr(), W2.data_ptr(),
             b2.data_ptr(), box_valid.data_ptr(), out.data_ptr(), G, A, B, K,
             O, col, ksplit, X.device.index,
             torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(err, "affinity_rank")


affinity_rank.launches = 0   # kernel launches since the last reset
# those of the bf16 mode, and of them those on the tensor cores
affinity_rank.bf16dot = SimpleNamespace(launches=0, mma_launches=0)


def _check(X, Y, b1, W2, b2, box_valid, col):
    """Raise on what the kernel does not take; returns (G, A, B, K, O)."""
    if X.device.type != "cuda":
        raise ValueError(f"affinity_rank: unsupported device {X.device}")
    G, A, K = X.shape
    B, O = Y.shape[1], W2.shape[1]
    want = {"X": (X, torch.float32, (G, A, K)),
            "Y": (Y, torch.float32, (G, B, K)),
            "b1": (b1, torch.float32, (K,)),
            "W2": (W2, torch.float32, (K, O)),
            "b2": (b2, torch.float32, (O,)),
            "box_valid": (box_valid, torch.bool, (G, B))}
    for name, (t, dtype, shape) in want.items():
        if t.device != X.device:
            raise ValueError(f"affinity_rank: {name} on {t.device}, X on "
                             f"{X.device}")
        if t.dtype != dtype:
            raise TypeError(f"affinity_rank: {name} is {t.dtype}, needs "
                            f"{dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"affinity_rank: {name} has shape "
                             f"{tuple(t.shape)}, needs {shape}")
        if not t.is_contiguous():
            raise ValueError(f"affinity_rank: {name} is not contiguous")
    if not 0 <= col < O:
        raise ValueError(f"affinity_rank: affinity_col={col} outside "
                         f"0..{O - 1}")
    check_grid_size("affinity_rank", G, A, B, K)
    if 4 * B * 4 + 2048 > _SMEM:    # 4 rows of scores and the K-split partials
        raise ValueError(f"affinity_rank: B={B} boxes exceed a block's "
                         f"shared memory ({_SMEM} bytes)")
    return G, A, B, K, O
