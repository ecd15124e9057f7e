"""Masked Keras LSTM recurrence over pre-projected inputs, forward.

Counterpart of ``icl/ops/lstm_kernel.py`` (both Pallas recurrences) with the
semantics of ``_lstm_recurrence_fwd_impl`` in ``icl/models/rnn.py``: gate
slabs i, f, c~, o; ``c = f*c_prev + i*c~``; ``h = o*tanh(c)``; at a masked
step the carry passes through, so ``hs`` holds the carried state at padded
steps and ``h_final == hs[:, L-1]`` (zeros for a length-0 row).

Layout, direction-major as the Pallas kernels had it::

    x_proj [G, L, B, 4H]   input projection + bias (a BiLSTM's direction 1
                           already time-reversed)
    mask   [G, L, B]       bool step validity
    R      [G, H, 4H]      recurrent kernels
    ->  hs [G, L, B, H], h_final [G, B, H]

* :func:`lstm_recurrence_reference` is the plain PyTorch version: L Python
  steps of a batched matmul and the gate arithmetic.
* :func:`lstm_recurrence` is the wrapper: for CUDA tensors it launches the
  hand-written kernel ``icl_torch/csrc/lstm_recurrence.cu`` (all L steps in
  one launch); for CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from icl_torch.ops import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_H = 256   # a block holds 4 threads per hidden unit (csrc/lstm_recurrence.cu)


def lstm_recurrence_reference(x_proj: torch.Tensor, mask: torch.Tensor,
                              R: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: L steps of ``z = x_proj[:, t] + h @ R`` and the gates."""
    G, L, B, H4 = x_proj.shape
    H = H4 // 4
    h = x_proj.new_zeros((G, B, H))
    c = x_proj.new_zeros((G, B, H))
    hs = []
    for t in range(L):
        z = x_proj[:, t] + torch.bmm(h, R)
        i = torch.sigmoid(z[..., :H])
        f = torch.sigmoid(z[..., H:2 * H])
        g = torch.tanh(z[..., 2 * H:3 * H])
        o = torch.sigmoid(z[..., 3 * H:])
        c_t = f * c + i * g
        h_t = o * torch.tanh(c_t)
        m = mask[:, t, :, None]
        h = torch.where(m, h_t, h)          # Keras mask: carry through
        c = torch.where(m, c_t, c)
        hs.append(h)
    hs = torch.stack(hs, 1) if hs else x_proj.new_zeros((G, 0, B, H))
    return hs, h


def lstm_recurrence(x_proj: torch.Tensor, mask: torch.Tensor,
                    R: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`lstm_recurrence_reference`; the kernel on
    CUDA.  Empty inputs (G, L or B = 0) return without a launch."""
    if x_proj.device.type == "cpu":
        return lstm_recurrence_reference(x_proj, mask, R)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_recurrence: unsupported device "
                         f"{x_proj.device}")
    G, L, B, H4 = x_proj.shape
    H = R.shape[1]
    _check(x_proj, mask, R, G, L, B, H)
    dev = x_proj.device
    hs = torch.empty((G, L, B, H), dtype=torch.float32, device=dev)
    h_final = torch.empty((G, B, H), dtype=torch.float32, device=dev)
    if G == 0 or L == 0 or B == 0:
        return hs, h_final.zero_()
    lib = _build.load("lstm_recurrence", "icl_lstm_recurrence_f32",
                      _ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.icl_lstm_recurrence_f32(
        x_proj.data_ptr(), mask.data_ptr(), R.data_ptr(), hs.data_ptr(),
        h_final.data_ptr(), G, L, B, H, dev.index, stream)
    _build.check(err, "lstm_recurrence")
    lstm_recurrence.launches += 1
    return hs, h_final


lstm_recurrence.launches = 0   # kernel launches since the last reset


def _check(x_proj, mask, R, G, L, B, H) -> None:
    for name, t in (("x_proj", x_proj), ("mask", mask), ("R", R)):
        if t.device != x_proj.device:
            raise ValueError(f"lstm_recurrence: {name} on {t.device}, "
                             f"x_proj on {x_proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_recurrence: {name} is not contiguous")
    if x_proj.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError(f"lstm_recurrence: needs float32 x_proj and R, got "
                        f"{x_proj.dtype} and {R.dtype}")
    if mask.dtype != torch.bool:
        raise TypeError(f"lstm_recurrence: mask is {mask.dtype}, needs bool")
    if tuple(x_proj.shape) != (G, L, B, 4 * H):
        raise ValueError(f"lstm_recurrence: x_proj {tuple(x_proj.shape)} "
                         f"does not match R {tuple(R.shape)}")
    if tuple(R.shape) != (G, H, 4 * H) or tuple(mask.shape) != (G, L, B):
        raise ValueError(f"lstm_recurrence: R {tuple(R.shape)} or mask "
                         f"{tuple(mask.shape)} does not match x_proj "
                         f"{tuple(x_proj.shape)}")
    if not 1 <= H <= MAX_H or G > 65535:
        raise ValueError(f"lstm_recurrence: H={H} outside 1..{MAX_H} or "
                         f"G={G} above 65535")
