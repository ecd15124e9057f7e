"""Training grid head with dropout, and with the cross-entropy fused in.

Counterpart of ``icl/ops/grid_head_train.py``::

    out[g,a,b,:] = dropout(relu(X[g,a] + b1 + Y[g,b])) @ W2 + b2

Two training primitives, each a ``torch.autograd.Function``:

* :func:`grid_head_train` returns the ``[G,A,B,O]`` logits (the pair-form
  step gathers its pair cells from them).  Forward kernel K5, backward
  kernel K6 (cotangent ``[G,A,B,O]`` -> dX, dY, dW2, db1; db2 = sum of the
  cotangent, outside the kernel).
* :func:`grid_head_train_loss` folds the per-cell CE in and returns only
  ``(sum ce*w, sum hits, sum valid)``.  Forward kernel K7, backward kernel
  K8 (recomputes the logits and the softmax, feeds
  ``(softmax - onehot) * w * g`` into dX, dY, dW2, db1, db2; ``weights``
  gets no gradient).  The production train step.

The dropout mask is a pure function of ``(seeds[g], a, b, k)``
(:func:`keep_mask`): a 32-bit integer hash that torch's int64 ops and the
kernels' uint32 ops compute bit for bit alike.  It depends on no blocking,
and each image's seed travels with it, so any split of the batch, and the
pair-form gather of single cells, reproduces the same mask.  Kept cells are
scaled by ``float32(1 / (1 - rate))``.

Each kernel has a plain version here: ``grid_head_train_reference`` and
``grid_head_train_loss_reference`` (the materialised grid, differentiable
through autograd; they are also the forward kernels' plain versions) and
the explicit backward formulas ``grid_head_train_bwd_plain`` and
``grid_head_train_loss_bwd_plain``.  A kernel wrapper runs the plain version
for CPU tensors and launches its kernel (``icl_torch/csrc/
grid_head_train.cu``) for CUDA tensors, counting launches in ``launches``.

``exact`` (default True) picks the precision of the head's contractions,
as the reference's ``exact_grads`` does.  True: exact f32 (the reference
under ``--matmul_precision highest``).  False: the one-pass bf16 mode (the
reference's default training precision, Mosaic's ``Precision.DEFAULT``):
both operands of the logit dot ``hd . W2``, of ``dh = g . W2^T`` and of
``dW2 = hd^T . g`` are rounded to bf16 (nearest even) and their exact
products summed in f32; hd is rounded after the dropout scale, and g is
the cell cotangent (K8: g3 = (softmax - onehot) * w * gl from the one-pass
logits).  Everything else stays f32 and unrounded: dz = dh * scale, dX,
dY, db1 and db2 (the sum of the unrounded g3).  The plain versions honour
``exact`` on every device; the CUDA entry points of the mode are
``icl_ght_*_onepass``, and their launches count in ``<wrapper>.onepass.
launches``.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from icl_torch.ops import _build
from icl_torch.ops.ce import onehot_ce
from icl_torch.ops.grid_head import aligned16, check_grid_size, launch_plan
from icl_torch.util import trace

MAX_O = 8            # kMaxO in csrc/grid_head_tile.cuh
_BWD_SMEM = 227 * 1024   # a block's shared memory: the backward kernels' limit
_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B     # hash32's multiplier; < 2**27, so int64 never overflows
_P, _I, _U, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_float)
_DIMS = [_I] * 5 + [_U, _F]               # G, A, B, K, O, thr, scale
_PLAN = [_I]                              # ksplit
_TAIL = [_I, _P]                          # device, stream
_ARGTYPES = {
    "icl_ght_fwd": [_P] * 7 + _DIMS + _PLAN + _TAIL,
    "icl_ght_bwd": [_P] * 10 + _DIMS + _TAIL,
    "icl_ght_loss_fwd": [_P] * 10 + [_I] + _DIMS + _PLAN + _TAIL,
    "icl_ght_loss_bwd": [_P] * 14 + _DIMS + _PLAN + _TAIL,
}   # each entry point has an _f32 and a _onepass symbol


# --- dropout mask ----------------------------------------------------------

def _keep_threshold(rate: float) -> int:
    """Keep iff bits >= threshold, so P(keep) = 1 - rate (bits uniform on
    32 bits)."""
    return min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)


def dropout_scale(rate: float) -> float:
    """The factor on kept cells, ``float32(1 / (1 - rate))``."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer hash of int64 values in [0, 2**32); = hash32 in the
    kernels' source (uint32 arithmetic)."""
    x = (((x >> 16) ^ x) * _MIX) & _M32
    x = (((x >> 16) ^ x) * _MIX) & _M32
    return (x >> 16) ^ x


def keep_mask(seeds: torch.Tensor, a: torch.Tensor, b: torch.Tensor, K: int,
              rate: float) -> torch.Tensor:
    """Dropout keep mask of cells ``(seeds, a, b)`` (broadcast together to
    a shape S) over hidden units 0..K-1 -> bool ``S + [K]``.

    bits = hash(hash(hash(hash(seed) ^ a) ^ b) ^ k); keep iff bits >=
    round(rate * 2**32).
    """
    h = _hash32(seeds.long() & _M32)
    h = _hash32(h ^ a.long())
    h = _hash32(h ^ b.long())
    k = torch.arange(K, device=h.device)
    return _hash32(h[..., None] ^ k) >= _keep_threshold(rate)


def dropout_keep_mask(seeds: torch.Tensor, A: int, B: int, K: int,
                      rate: float) -> torch.Tensor:
    """The mask of a whole grid: seeds int32[G] -> bool [G, A, B, K]."""
    dev = seeds.device
    return keep_mask(seeds[:, None, None], torch.arange(A, device=dev)[:, None],
                     torch.arange(B, device=dev), K, rate)


def dropout_applies(rate: float) -> bool:
    """Dropout changes anything (the kernels skip the mask otherwise)."""
    return _keep_threshold(rate) > 0


def _hd_scale(X, Y, b1, seeds, rate):
    """The materialised ``dropout(relu(z))`` and its derivative factor
    ``[z > 0] * keep / (1 - rate)``, z = (X + b1) + Y, as the kernels form
    them: [G, A, B, K] each."""
    z = (X + b1)[:, :, None, :] + Y[:, None, :, :]
    hd = torch.relu(z)
    scale = (z > 0).to(z.dtype)
    if dropout_applies(rate):
        G, A, B, K = z.shape
        kf = torch.where(dropout_keep_mask(seeds, A, B, K, rate),
                         dropout_scale(rate), 0.0)
        hd, scale = hd * kf, scale * kf
    return hd, scale


# --- plain versions ----------------------------------------------------------

def grid_ce_sums(logits: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor):
    """``(sum ce*w, sum hits, sum valid)`` over a logit grid; valid = w > 0,
    hits use the first-max argmax.  The in-kernel CE's plain version."""
    ce, _ = onehot_ce(logits, labels)
    valid = weights > 0.0
    hits = (logits.argmax(dim=-1) == labels) & valid
    return ((ce * weights).sum(), hits.to(torch.float32).sum(),
            valid.to(torch.float32).sum())


def _operand(t: torch.Tensor, exact: bool) -> torch.Tensor:
    """An operand of a head contraction: as it is when ``exact``, else
    rounded to bf16 (nearest even) and widened back, so the f32 products of
    two such values are exact (one bf16 pass)."""
    return t if exact else t.to(torch.bfloat16).to(t.dtype)


def grid_head_train_reference(X, Y, b1, W2, b2, seeds, rate: float = 0.0,
                              exact: bool = True):
    """Plain version of K5: the materialised masked grid -> [G,A,B,O].
    Differentiable through autograd; ``seeds`` may be None at rate 0."""
    hd, _ = _hd_scale(X, Y, b1, seeds, rate)
    return torch.einsum("gabk,ko->gabo", _operand(hd, exact),
                        _operand(W2, exact)) + b2


def grid_head_train_loss_reference(X, Y, b1, W2, b2, seeds, labels, weights,
                                   rate: float = 0.0, exact: bool = True):
    """Plain version of K7: the head, then :func:`grid_ce_sums`."""
    return grid_ce_sums(grid_head_train_reference(X, Y, b1, W2, b2, seeds,
                                                  rate, exact),
                        labels, weights)


def grid_head_train_bwd_plain(X, Y, b1, W2, seeds, g, rate: float,
                              exact: bool = True):
    """Plain version of K6: cotangent g [G,A,B,O] -> dX, dY, dW2, db1."""
    hd, scale = _hd_scale(X, Y, b1, seeds, rate)
    g = _operand(g, exact)
    dz = torch.einsum("gabo,ko->gabk", g, _operand(W2, exact)) * scale
    return (dz.sum(2), dz.sum(1),
            torch.einsum("gabk,gabo->ko", _operand(hd, exact), g),
            dz.sum((0, 1, 2)))


def _dlogits(logits, labels, weights, gl):
    """``(softmax - onehot) * w * gl`` per cell, the CE's logit gradient."""
    sh = logits - logits.max(dim=-1, keepdim=True).values
    e = torch.exp(sh)
    probs = e / e.sum(dim=-1, keepdim=True)
    onehot = (labels[..., None] == torch.arange(logits.shape[-1],
                                                device=logits.device))
    return (probs - onehot.to(probs.dtype)) * (weights * gl)[..., None]


def grid_head_train_dlogits_plain(X, Y, b1, W2, b2, seeds, labels, weights,
                                  gl, rate: float, exact: bool = True):
    """Plain version of K8's first half: the logit gradient g3 [G,A,B,O]
    of ``gl * sum ce * w`` (the logits recomputed as K7 computes them)."""
    logits = grid_head_train_reference(X, Y, b1, W2, b2, seeds, rate, exact)
    return _dlogits(logits, labels, weights, gl)


def grid_head_train_loss_bwd_plain(X, Y, b1, W2, b2, seeds, labels, weights,
                                   gl, rate: float, exact: bool = True):
    """Plain version of K8: loss cotangent gl -> dX, dY, dW2, db1, db2."""
    g3 = grid_head_train_dlogits_plain(X, Y, b1, W2, b2, seeds, labels,
                                       weights, gl, rate, exact)
    dX, dY, dW2, db1 = grid_head_train_bwd_plain(X, Y, b1, W2, seeds, g3,
                                                 rate, exact)
    return dX, dY, dW2, db1, g3.sum((0, 1, 2))


# --- kernel wrappers -----------------------------------------------------------

def grid_head_train_fwd(X, Y, b1, W2, b2, seeds, rate: float,
                        exact: bool = True):
    """K5: [G,A,B,O] logits with dropout applied."""
    if X.device.type == "cpu":
        return grid_head_train_reference(X, Y, b1, W2, b2, seeds, rate, exact)
    G, A, B, K, O = _check("grid_head_train_fwd", X, Y, b1, W2, b2, seeds)
    out = torch.empty((G, A, B, O), dtype=torch.float32, device=X.device)
    if out.numel() == 0:
        return out
    plan = launch_plan(G, A, B, K, O, aligned16(X, Y, b1, W2))
    _launch("icl_ght_fwd", grid_head_train_fwd, exact, X,
            X, Y, b1, W2, b2, seeds, out, dims=(G, A, B, K, O), rate=rate,
            plan=plan)
    return out


def grid_head_train_bwd(X, Y, b1, W2, seeds, g, rate: float,
                        exact: bool = True):
    """K6: cotangent g [G,A,B,O] -> (dX, dY, dW2, db1)."""
    if X.device.type == "cpu":
        return grid_head_train_bwd_plain(X, Y, b1, W2, seeds, g, rate, exact)
    grid = (X.shape[0], X.shape[1], Y.shape[1], W2.shape[1])
    G, A, B, K, O = _check("grid_head_train_bwd", X, Y, b1, W2, None, seeds,
                           cells={"g": (g, torch.float32, grid)})
    _check_bwd_grid("grid_head_train_bwd", A, B, O)
    dev = X.device
    # the kernels write every element of dX, dY and sums; an empty grid
    # launches nothing and its gradients are zeros
    new = torch.empty if G and A and B else torch.zeros
    dX = new(X.shape, dtype=torch.float32, device=dev)
    dY = new(Y.shape, dtype=torch.float32, device=dev)
    sums = new(K * O + K, dtype=torch.float32, device=dev)
    if G and A and B:
        part = torch.empty((G, K * O + K), dtype=torch.float32, device=dev)
        _launch("icl_ght_bwd", grid_head_train_bwd, exact, X,
                X, Y, b1, W2, seeds, g, dX, dY, part, sums,
                dims=(G, A, B, K, O), rate=rate)
    return dX, dY, sums[:K * O].view(K, O), sums[K * O:]


def grid_head_train_loss_fwd(X, Y, b1, W2, b2, seeds, labels, weights,
                             rate: float, exact: bool = True):
    """K7: (sum ce*w, sum hits, sum valid) as three 0-d tensors."""
    if X.device.type == "cpu":
        return grid_head_train_loss_reference(X, Y, b1, W2, b2, seeds, labels,
                                              weights, rate, exact)
    G, A, B, K, O = _check("grid_head_train_loss_fwd", X, Y, b1, W2, b2, seeds,
                           cells=_label_cells(X, Y, labels, weights))
    sums = torch.zeros(3, dtype=torch.float32, device=X.device)
    if G and A and B:
        plan = launch_plan(G, A, B, K, O, aligned16(X, Y, b1, W2))
        part = torch.empty((plan.blocks, 3), dtype=torch.float32,
                           device=X.device)     # a row of sums a block
        _launch("icl_ght_loss_fwd", grid_head_train_loss_fwd, exact, X,
                X, Y, b1, W2, b2, seeds, labels, weights, part, sums,
                plan.blocks, dims=(G, A, B, K, O), rate=rate, plan=plan)
    return sums[0], sums[1], sums[2]


def grid_head_train_loss_bwd(X, Y, b1, W2, b2, seeds, labels, weights, gl,
                             rate: float, exact: bool = True, *,
                             g3_out: torch.Tensor | None = None):
    """K8: loss cotangent gl (0-d) -> (dX, dY, dW2, db1, db2).

    ``g3_out`` (f32 [G,A,B,O], contiguous), if given, receives the logit
    gradient g3 the first half computes and the second consumes.  In the
    one-pass mode g3 is rounded to bf16 where the logits' f32 sum order
    may have moved it by a unit, so the checks hold each half to its plain
    version on the same g3."""
    if X.device.type == "cpu":
        if g3_out is None:
            return grid_head_train_loss_bwd_plain(X, Y, b1, W2, b2, seeds,
                                                  labels, weights, gl, rate,
                                                  exact)
        g3_out.copy_(grid_head_train_dlogits_plain(
            X, Y, b1, W2, b2, seeds, labels, weights, gl, rate, exact))
        return (*grid_head_train_bwd_plain(X, Y, b1, W2, seeds, g3_out, rate,
                                           exact), g3_out.sum((0, 1, 2)))
    cells = _label_cells(X, Y, labels, weights)
    if g3_out is not None:
        cells["g3_out"] = (g3_out, torch.float32,
                           (*cells["labels"][2], W2.shape[1]))
    G, A, B, K, O = _check("grid_head_train_loss_bwd", X, Y, b1, W2, b2,
                           seeds, cells=cells)
    _check_bwd_grid("grid_head_train_loss_bwd", A, B, O)
    dev = X.device
    gl = gl.to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    new = torch.empty if G and A and B else torch.zeros   # as in K6
    dX = new(X.shape, dtype=torch.float32, device=dev)
    dY = new(Y.shape, dtype=torch.float32, device=dev)
    sums = new(K * O + K + O, dtype=torch.float32, device=dev)
    if G and A and B:
        g3 = (torch.empty((G, A, B, O), dtype=torch.float32, device=dev)
              if g3_out is None else g3_out)
        part = torch.empty((G, K * O + K + O), dtype=torch.float32, device=dev)
        _launch("icl_ght_loss_bwd", grid_head_train_loss_bwd, exact, X,
                X, Y, b1, W2, b2, seeds, labels, weights, gl, g3, dX, dY,
                part, sums, dims=(G, A, B, K, O), rate=rate,
                plan=launch_plan(G, A, B, K, O, aligned16(X, Y, b1, W2)))
    return (dX, dY, sums[:K * O].view(K, O), sums[K * O:K * O + K],
            sums[K * O + K:])


for _fn in (grid_head_train_fwd, grid_head_train_bwd, grid_head_train_loss_fwd,
            grid_head_train_loss_bwd):
    _fn.launches = 0   # kernel launches since the last reset
    _fn.onepass = SimpleNamespace(launches=0)   # those of the one-pass mode


def _launch(entry, wrapper, exact, like, *args, dims, rate, plan=None):
    """Calls an entry point, ``<entry>_f32`` or, unless ``exact``,
    ``<entry>_onepass``, and counts the launch on ``wrapper`` (or its
    ``onepass``): tensors (as pointers) and ints in ``args``, then the
    dims, the dropout threshold and scale, the forward family's K split
    (``plan.ksplit``), the device and the stream."""
    symbol = f"{entry}_{'f32' if exact else 'onepass'}"
    lib = _build.load("grid_head_train", symbol, _ARGTYPES[entry])
    dev = like.device
    err = getattr(lib, symbol)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        *dims, _keep_threshold(rate), dropout_scale(rate),
        *((plan.ksplit,) if plan is not None else ()), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, wrapper.__name__)
    trace.launched(wrapper if exact else wrapper.onepass)


def _check_bwd_grid(what, A, B, O):
    """The backward kernel keeps one image's cotangents [A, B, O], 128
    threads' partials over B + O + 1 columns, and each of its 4 warps' work
    list [B] and hash keys [4, B] in a block's shared memory."""
    need = 4 * (A * B * O + 128 * (B + O + 1) + 20 * B)
    if need > _BWD_SMEM:
        raise ValueError(f"{what}: a grid of A={A} by B={B} cells, O={O}, "
                         f"needs {need} bytes of shared memory a block; the "
                         f"kernel has {_BWD_SMEM}")


def _label_cells(X, Y, labels, weights):
    cells = (X.shape[0], X.shape[1], Y.shape[1])
    return {"labels": (labels, torch.int32, cells),
            "weights": (weights, torch.float32, cells)}


def _check(what, X, Y, b1, W2, b2, seeds, cells=None):
    """Raise on what the kernels do not take; returns (G, A, B, K, O)."""
    if X.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {X.device}")
    G, A, K = X.shape
    B, O = Y.shape[1], W2.shape[1]
    want = {"X": (X, torch.float32, (G, A, K)),
            "Y": (Y, torch.float32, (G, B, K)),
            "b1": (b1, torch.float32, (K,)),
            "W2": (W2, torch.float32, (K, O)),
            "seeds": (seeds, torch.int32, (G,))}
    if b2 is not None:
        want["b2"] = (b2, torch.float32, (O,))
    want.update(cells or {})
    for name, (t, dtype, shape) in want.items():
        if t.device != X.device:
            raise ValueError(f"{what}: {name} on {t.device}, X on {X.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, needs {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"needs {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if not 1 <= O <= MAX_O:
        raise ValueError(f"{what}: O={O} outside 1..{MAX_O}")
    if G > 65535:
        raise ValueError(f"{what}: G={G} exceeds the launch grid")
    check_grid_size(what, G, A, B, K)
    return G, A, B, K, O


# --- autograd ------------------------------------------------------------------

class GridHeadTrain(torch.autograd.Function):
    """K5 forward, K6 backward (see :func:`grid_head_train`)."""

    @staticmethod
    def forward(ctx, X, Y, b1, W2, b2, seeds, rate, exact):
        ctx.rate, ctx.exact = rate, exact
        ctx.save_for_backward(X, Y, b1, W2, seeds)
        return grid_head_train_fwd(X, Y, b1, W2, b2, seeds, rate, exact)

    @staticmethod
    def backward(ctx, g):
        X, Y, b1, W2, seeds = ctx.saved_tensors
        g = g.contiguous()
        dX, dY, dW2, db1 = grid_head_train_bwd(X, Y, b1, W2, seeds, g,
                                               ctx.rate, ctx.exact)
        return dX, dY, db1, dW2, g.sum((0, 1, 2)), None, None, None


class GridHeadTrainLoss(torch.autograd.Function):
    """K7 forward, K8 backward (see :func:`grid_head_train_loss`)."""

    @staticmethod
    def forward(ctx, X, Y, b1, W2, b2, seeds, labels, weights, rate, exact):
        ctx.rate, ctx.exact = rate, exact
        ctx.save_for_backward(X, Y, b1, W2, b2, seeds, labels, weights)
        loss, hits, nval = grid_head_train_loss_fwd(
            X, Y, b1, W2, b2, seeds, labels, weights, rate, exact)
        ctx.mark_non_differentiable(hits, nval)
        return loss, hits, nval

    @staticmethod
    def backward(ctx, gl, _hits, _nval):
        X, Y, b1, W2, b2, seeds, labels, weights = ctx.saved_tensors
        dX, dY, dW2, db1, db2 = grid_head_train_loss_bwd(
            X, Y, b1, W2, b2, seeds, labels, weights, gl, ctx.rate,
            ctx.exact)
        return dX, dY, db1, dW2, db2, None, None, None, None, None


def grid_head_train(X, Y, b1, W2, b2, seeds, rate: float = 0.0,
                    exact: bool = True):
    """Training grid head -> [G,A,B,O] logits.

    X [G,A,K], Y [G,B,K] f32; b1 [K], W2 [K,O], b2 [O]; seeds int32[G]
    per-image dropout seeds; rate a Python float in [0, 1); ``exact``: exact
    f32 head contractions, else the one-pass bf16 mode (the module's note).
    Gradients flow to X, Y, b1, W2, b2.
    """
    return GridHeadTrain.apply(X, Y, b1, W2, b2, seeds, rate, exact)


def grid_head_train_loss(X, Y, b1, W2, b2, seeds, labels, weights,
                         rate: float = 0.0, exact: bool = True):
    """Training grid head with the CE fused in -> (sum ce*w, sum hits,
    sum valid), three 0-d tensors.

    labels int32[G,A,B], weights f32[G,A,B] (constant: no gradient).  The
    caller normalises: ``loss = loss_sum / max(sum weights, 1)``, ``acc =
    hits / max(nvalid, 1)``; cells of weight 0 take part in neither.
    ``exact`` as in :func:`grid_head_train`.
    """
    return GridHeadTrainLoss.apply(X, Y, b1, W2, b2, seeds, labels, weights,
                                   rate, exact)
