"""Fused M x M grid head: ``out[g,a,b,:] = relu(X[g,a]+Y[g,b]+b1) @ W2 + b2``.

Counterpart of ``icl/ops/grid_head.py``.  Because concatenation into a Dense
layer distributes over the weight, the relation head over every ordered
mention pair ``relu([m_a; m_b] @ W1 + b1) @ W2 + b2`` equals
``relu(X[a] + Y[b] + b1) @ W2 + b2`` with ``X = m @ W1_top`` and
``Y = m @ W1_bot`` projected once per mention.

* :func:`grid_head_reference` is the plain PyTorch version; it materialises
  the [G, A, B, K] activation.
* :func:`grid_head` is the wrapper: for CUDA tensors it launches the
  hand-written kernel ``icl_torch/csrc/grid_head.cu`` (the [A, B, K]
  activation never leaves the SM); for CPU tensors it runs the plain
  version.  A CUDA call that the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

from icl_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
MAX_O = 8   # kMaxO in csrc/grid_head.cu


def grid_head_reference(X: torch.Tensor, Y: torch.Tensor, b1: torch.Tensor,
                        W2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version: [G,A,K], [G,B,K] -> [G,A,B,O] via the full grid."""
    h = torch.relu(X[:, :, None, :] + Y[:, None, :, :] + b1)
    return torch.einsum("gabk,ko->gabo", h, W2) + b2


def grid_head(X: torch.Tensor, Y: torch.Tensor, b1: torch.Tensor,
              W2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`grid_head_reference`; the kernel on CUDA.

    An empty grid (G, A or B = 0) returns zeros without a launch.
    """
    if X.device.type == "cpu":
        return grid_head_reference(X, Y, b1, W2, b2)
    if X.device.type != "cuda":
        raise ValueError(f"grid_head: unsupported device {X.device}")
    G, A, K = X.shape
    B = Y.shape[1]
    O = W2.shape[1]
    _check(X, Y, b1, W2, b2, G, A, B, K, O)
    out = torch.empty((G, A, B, O), dtype=torch.float32, device=X.device)
    if G == 0 or A == 0 or B == 0:
        return out.zero_()
    lib = _build.load("grid_head", "icl_grid_head_f32", _ARGTYPES)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    err = lib.icl_grid_head_f32(
        X.data_ptr(), Y.data_ptr(), b1.data_ptr(), W2.data_ptr(),
        b2.data_ptr(), out.data_ptr(), G, A, B, K, O, X.device.index, stream)
    _build.check(err, "grid_head")
    grid_head.launches += 1
    return out


grid_head.launches = 0   # kernel launches since the last reset


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
    if G * A >= 2**31:
        raise ValueError(f"grid_head: G*A={G * A} exceeds the launch grid")
