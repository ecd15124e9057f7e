"""Masked Keras LSTM recurrence over pre-projected inputs, with its backward.

Counterpart of ``icl/ops/lstm_kernel.py`` (both Pallas recurrences) with the
semantics of ``lstm_recurrence`` in ``icl/models/rnn.py``: gate slabs i, f,
c~, o; ``c = f*c_prev + i*c~``; ``h = o*tanh(c)``; at a masked step the carry
passes through, so ``hs`` holds the carried state at padded steps and
``h_final == hs[:, L-1]`` (zeros for a length-0 row).

Layout, direction-major as the Pallas kernels had it::

    x_proj [G, L, B, 4H]   input projection + bias (a BiLSTM's direction 1
                           already time-reversed)
    mask   [G, L, B]       bool step validity
    R      [G, H, 4H]      recurrent kernels
    ->  hs [G, L, B, H], h_final [G, B, H]

* :func:`lstm_recurrence_reference` is the plain PyTorch version: L Python
  steps of a batched matmul and the gate arithmetic (differentiable through
  autograd).
* :func:`lstm_recurrence` is a ``torch.autograd.Function``.  Its forward
  launches the hand-written kernel ``icl_torch/csrc/lstm_recurrence.cu``
  (all L steps in one launch, R resident in the shared memory of a
  thread-block cluster: 8 blocks up to H = 256, 16 up to 368; above, up to
  ``MAX_H`` = 512, the 16 blocks read R from device memory every step in
  f32, while the bf16 mode keeps R on chip at every width) for CUDA
  tensors and runs the plain version for CPU tensors.  When a gradient is needed, the forward also keeps the
  reference's residual set (``rnn.py: _lstm_recurrence_fwd_impl``): the
  post-activation gates (not masked), c after the mask, and hs.
* The backward mirrors ``_lstm_recurrence_bwd_impl`` (a reverse lax.scan
  in the JAX package, which has no Pallas kernel for it): the dgates .
  R^T chain runs over the steps, dx_proj is dgates, and dR is one GEMM
  afterwards (hs shifted by a step against dgates).  On CUDA the
  chain is the hand-written kernel ``icl_torch/csrc/lstm_recurrence_bwd.cu``
  (:func:`lstm_recurrence_bwd_kernel`: all L steps in one launch, R^T held
  in the shared memory of a cluster as the forward holds R), counted in
  ``lstm_recurrence.bwd.launches`` (its bf16 mode in
  ``lstm_recurrence.bwd_bf16.launches``) and, while a profile runs, in
  the counter ``lstm.bwd.kernel``.  :func:`lstm_recurrence_bwd` is its
  plain version, a Python reverse loop: the CPU path and the reference.

Two dtypes: float32, and bfloat16 (``--compute_dtype bf16``; the
reference's lax.scan in bf16).  In bf16 x_proj, R, hs, h_final and the
residuals are bf16; the plain version runs its eager ops on bf16 tensors,
each computed in f32 and rounded once, and the kernel's bf16 entry point
``icl_lstm_recurrence_bf16`` rounds at the same points (the note in the
source), with h . R on the tensor cores (``mma.sync`` bf16, each chunk of
16 products summed in f32, the chunks added in order); its launches count
in ``lstm_recurrence.bf16.launches``.  The backward runs in the
residuals' dtype, as the reference's does; the kernel's bf16 mode rounds
where the plain loop's eager bf16 ops round (the note in its source).
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from icl_torch.ops import _build
from icl_torch.util import trace

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_H = 512   # a unit a lane of a 16-block cluster (csrc/lstm_recurrence.cu)


def lstm_recurrence_reference(x_proj: torch.Tensor, mask: torch.Tensor,
                              R: torch.Tensor, residuals: bool = False):
    """Plain version: L steps of ``z = x_proj[:, t] + h @ R`` and the gates.

    Returns ``(hs, h_final)``, and with ``residuals`` also ``(gates [G, L,
    B, 4H], c [G, L, B, H])`` as the kernel writes them.
    """
    G, L, B, H4 = x_proj.shape
    H = H4 // 4
    h = x_proj.new_zeros((G, B, H))
    c = x_proj.new_zeros((G, B, H))
    hs, gates, cs = [], [], []
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
        if residuals:
            gates.append(torch.cat([i, f, g, o], dim=-1))
            cs.append(c)

    def stack(steps, width):
        return (torch.stack(steps, 1) if steps
                else x_proj.new_zeros((G, 0, B, width)))

    if not residuals:
        return stack(hs, H), h
    return stack(hs, H), h, stack(gates, H4), stack(cs, H)


def lstm_recurrence_fwd(x_proj, mask, R, residuals: bool = False):
    """The forward: the kernel on CUDA, the plain version on the CPU.
    Returns what :func:`lstm_recurrence_reference` does."""
    if x_proj.device.type == "cpu":
        return lstm_recurrence_reference(x_proj, mask, R, residuals)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_recurrence: unsupported device "
                         f"{x_proj.device}")
    G, L, B, H4 = x_proj.shape
    H = R.shape[1]
    _check(x_proj, mask, R, G, L, B, H)
    kw = {"dtype": x_proj.dtype, "device": x_proj.device}
    hs = torch.empty((G, L, B, H), **kw)
    h_final = torch.empty((G, B, H), **kw)
    res = ((torch.empty((G, L, B, 4 * H), **kw),
            torch.empty((G, L, B, H), **kw)) if residuals else ())
    if G == 0 or L == 0 or B == 0:
        return hs, h_final.zero_(), *res
    bf16 = x_proj.dtype == torch.bfloat16
    entry = "icl_lstm_recurrence_bf16" if bf16 else "icl_lstm_recurrence_f32"
    fn = getattr(_build.load("lstm_recurrence", entry, _ARGTYPES), entry)
    dev = x_proj.device
    err = fn(x_proj.data_ptr(), mask.data_ptr(), R.data_ptr(), hs.data_ptr(),
             h_final.data_ptr(), *((t.data_ptr() for t in res) if res
                                   else (None, None)),
             G, L, B, H, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lstm_recurrence")
    (lstm_recurrence.bf16 if bf16 else lstm_recurrence).launches += 1
    return hs, h_final, *res


def lstm_recurrence_bwd(gates, c, hs, R, mask, dhs, dhf):
    """Reverse loop of ``_lstm_recurrence_bwd_impl`` -> (dx_proj, dR), in
    the residuals' dtype (the cotangents are cast to it, as the reference
    casts them to its compute dtype): the plain version of
    :func:`lstm_recurrence_bwd_kernel`."""
    G, L, B, H = hs.shape
    m = mask[..., None].to(hs.dtype)                      # [G, L, B, 1]
    dhs, dhf = dhs.to(hs.dtype), dhf.to(hs.dtype)
    dh, dc = dhf, torch.zeros_like(dhf)
    dgates = torch.empty_like(gates)
    Rt = R.transpose(1, 2)
    for t in reversed(range(L)):
        dh = dh + dhs[:, t]
        mt = m[:, t]
        i, f, g, o = gates[:, t].split(H, dim=-1)
        tc = torch.tanh(c[:, t])          # == tanh(c~) wherever m == 1
        c_prev = c[:, t - 1] if t > 0 else torch.zeros_like(dc)
        dh_t = dh * mt
        dc_t = dc * mt + dh_t * o * (1 - tc * tc)
        do = dh_t * tc * o * (1 - o)
        df = dc_t * c_prev * f * (1 - f)
        di = dc_t * g * i * (1 - i)
        dg = dc_t * i * (1 - g * g)
        dgates[:, t] = torch.cat([di, df, dg, do], dim=-1)
        dh = torch.bmm(dgates[:, t], Rt) + dh * (1 - mt)
        dc = dc_t * f + dc * (1 - mt)
    return dgates, _dR(hs, dgates)


def _dR(hs, dgates):
    """One GEMM over the sequence: the post-mask h of step t - 1 is the
    true previous state of step t, and step 0's (zero) adds nothing."""
    return torch.einsum("glbh,glbk->ghk", hs[:, :-1], dgates[:, 1:])


def lstm_recurrence_bwd_kernel(gates, c, hs, R, mask, dhs, dhf):
    """What :func:`lstm_recurrence_bwd` computes, for CUDA tensors of one
    dtype, float32 or bfloat16 (the bf16 mode, counted apart): the L steps
    in one launch of ``csrc/lstm_recurrence_bwd.cu``, dR one GEMM after
    it.  Empty inputs (G, L or B = 0) return without a launch.  The
    arguments are checked before the library is built."""
    G, L, B, H = hs.shape
    _check_bwd(gates, c, hs, R, mask, dhs, dhf, G, L, B, H)
    dgates = torch.empty_like(gates)
    if G == 0 or L == 0 or B == 0:
        return dgates, _dR(hs, dgates)
    bf16 = hs.dtype == torch.bfloat16
    entry = f"icl_lstm_recurrence_bwd_{'bf16' if bf16 else 'f32'}"
    fn = getattr(_build.load("lstm_recurrence_bwd", entry, _ARGTYPES), entry)
    Rt = R.transpose(1, 2).contiguous()   # the kernel's loads coalesce on it
    dev = hs.device
    err = fn(gates.data_ptr(), c.data_ptr(), mask.data_ptr(), Rt.data_ptr(),
             dhs.data_ptr(), dhf.data_ptr(), dgates.data_ptr(), G, L, B, H,
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lstm_recurrence_bwd")
    (lstm_recurrence.bwd_bf16 if bf16 else lstm_recurrence.bwd).launches += 1
    trace.count("lstm.bwd.kernel")
    return dgates, _dR(hs, dgates)


class LSTMRecurrence(torch.autograd.Function):
    """Kernel (or plain) forward with residuals; the backward kernel on
    CUDA, the plain reverse loop on the CPU (see the module docstring),
    span ``lstm.backward`` (:mod:`icl_torch.util.trace`)."""

    @staticmethod
    def forward(ctx, x_proj, mask, R):
        if not any(ctx.needs_input_grad):
            return lstm_recurrence_fwd(x_proj, mask, R, residuals=False)
        hs, h_final, gates, c = lstm_recurrence_fwd(x_proj, mask, R,
                                                    residuals=True)
        ctx.save_for_backward(gates, c, hs, R, mask)
        return hs, h_final

    @staticmethod
    def backward(ctx, dhs, dhf):
        # on CUDA this runs on autograd's device thread
        with trace.span("lstm.backward"):
            gates, c, hs, R, mask = ctx.saved_tensors
            bwd = (lstm_recurrence_bwd_kernel if hs.device.type == "cuda"
                   else lstm_recurrence_bwd)
            dx_proj, dR = bwd(gates, c, hs, R, mask,
                              dhs.to(hs.dtype).contiguous(),
                              dhf.to(hs.dtype).contiguous())
        return dx_proj, None, dR


def lstm_recurrence(x_proj: torch.Tensor, mask: torch.Tensor,
                    R: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`lstm_recurrence_reference`; the kernel on
    CUDA, differentiable in x_proj and R.  Empty inputs (G, L or B = 0)
    return without a launch."""
    return LSTMRecurrence.apply(x_proj, mask, R)


lstm_recurrence.launches = 0   # kernel launches since the last reset
lstm_recurrence.bf16 = SimpleNamespace(launches=0)   # those of the bf16 mode
lstm_recurrence.bwd = SimpleNamespace(launches=0)    # the backward kernel's
lstm_recurrence.bwd_bf16 = SimpleNamespace(launches=0)   # its bf16 mode's


def _check(x_proj, mask, R, G, L, B, H) -> None:
    for name, t in (("x_proj", x_proj), ("mask", mask), ("R", R)):
        if t.device != x_proj.device:
            raise ValueError(f"lstm_recurrence: {name} on {t.device}, "
                             f"x_proj on {x_proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_recurrence: {name} is not contiguous")
    if x_proj.dtype not in (torch.float32, torch.bfloat16) or \
            R.dtype != x_proj.dtype:
        raise TypeError(f"lstm_recurrence: needs float32 or bfloat16 x_proj "
                        f"and R of one dtype, got {x_proj.dtype} and "
                        f"{R.dtype}")
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


def _check_bwd(gates, c, hs, R, mask, dhs, dhf, G, L, B, H) -> None:
    named = (("gates", gates), ("c", c), ("hs", hs), ("R", R),
             ("mask", mask), ("dhs", dhs), ("dhf", dhf))
    for name, t in named:
        if t.device.type != "cuda" or t.device != hs.device:
            raise ValueError(f"lstm_recurrence_bwd: {name} on {t.device}, "
                             f"needs hs's CUDA device ({hs.device})")
        if not t.is_contiguous():
            raise ValueError(f"lstm_recurrence_bwd: {name} is not "
                             f"contiguous")
        want = torch.bool if name == "mask" else hs.dtype
        if t.dtype != want or hs.dtype not in (torch.float32,
                                               torch.bfloat16):
            raise TypeError(f"lstm_recurrence_bwd: {name} is {t.dtype}, "
                            f"needs {want} (hs float32 or bfloat16)")
    shapes = {"gates": (G, L, B, 4 * H), "c": (G, L, B, H),
              "R": (G, H, 4 * H), "mask": (G, L, B), "dhs": (G, L, B, H),
              "dhf": (G, B, H)}
    for name, t in named:
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"lstm_recurrence_bwd: {name} "
                             f"{tuple(t.shape)} does not match hs "
                             f"{tuple(hs.shape)}, needs {shapes[name]}")
    if not 1 <= H <= MAX_H or G > 65535:
        raise ValueError(f"lstm_recurrence_bwd: H={H} outside 1..{MAX_H} "
                         f"or G={G} above 65535")
