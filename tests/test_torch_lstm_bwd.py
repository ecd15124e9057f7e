"""The recurrence's backward on the CPU: the plain reverse loop, and the
CUDA kernel's wrapper up to its launch.

The kernel itself (``icl_torch/csrc/lstm_recurrence_bwd.cu``) runs only on
the card: ``tests/test_torch_cuda.py -k recurrence_bwd``.  Here: CPU tensors
take the plain loop and leave the kernel's counters at 0; the plain
backward is autograd's through the plain forward; the wrapper's argument
checks raise before any build; ``lstm.bwd.kernel`` counts only while a
profile runs.  No JAX.
"""

from types import SimpleNamespace

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from icl_torch.ops import _build
from icl_torch.ops import lstm_recurrence as lr
from icl_torch.ops.lstm_recurrence import (lstm_recurrence,
                                           lstm_recurrence_bwd,
                                           lstm_recurrence_bwd_kernel,
                                           lstm_recurrence_fwd,
                                           lstm_recurrence_reference)
from icl_torch.util import trace


@pytest.fixture(autouse=True)
def _empty_log():
    trace.reset()
    yield
    trace.reset()


def _inputs(G, L, B, H, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    x_proj = torch.randn(G, L, B, 4 * H, generator=g, dtype=dtype)
    R = torch.randn(G, H, 4 * H, generator=g, dtype=dtype) / H ** 0.5
    lengths = torch.randint(0, L + 1, (B,), generator=g)
    if B:
        lengths[0] = 0          # a length-0 row
        lengths[-1] = L         # a full row
    t = torch.arange(L)[:, None]
    mask = torch.stack([t < lengths, (L - 1 - t) < lengths])[:G]
    return x_proj, mask.contiguous(), R


def _cotangents(G, L, B, H, which, dtype=torch.float64):
    g = torch.Generator().manual_seed(7)
    dhs = torch.randn(G, L, B, H, generator=g, dtype=dtype)
    dhf = torch.randn(G, B, H, generator=g, dtype=dtype)
    if which == "dhs":
        dhf.zero_()
    elif which == "dhf":
        dhs.zero_()
    return dhs, dhf


@pytest.mark.parametrize("which", ["both", "dhs", "dhf"])
@pytest.mark.parametrize("G,L,B,H", [(2, 7, 5, 6), (1, 1, 3, 4),
                                     (2, 9, 1, 3), (2, 0, 3, 4),
                                     (1, 4, 0, 5)])
def test_plain_backward_is_autograds_through_the_plain_forward(G, L, B, H,
                                                                which):
    """The custom backward on CPU tensors (the plain loop) against autograd
    through the plain forward, in float64; the kernel never counts."""
    x_proj, mask, R = _inputs(G, L, B, H)
    dhs, dhf = _cotangents(G, L, B, H, which)
    n0 = (lstm_recurrence.launches, lstm_recurrence.bwd.launches)
    grads = []
    for fn in (lstm_recurrence, lstm_recurrence_reference):
        x = x_proj.clone().requires_grad_()
        r = R.clone().requires_grad_()
        # the plain forward's outputs at L = 0 are constants
        outs = [(o, d) for o, d in zip(fn(x, mask, r), (dhs, dhf))
                if o.requires_grad]
        if not outs:
            grads.append((torch.zeros_like(x), torch.zeros_like(r)))
            continue
        dx, dr = torch.autograd.grad([o for o, _ in outs], (x, r),
                                     [d for _, d in outs], allow_unused=True)
        grads.append((torch.zeros_like(x) if dx is None else dx,
                      torch.zeros_like(r) if dr is None else dr))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    assert (lstm_recurrence.launches, lstm_recurrence.bwd.launches) == n0
    assert "lstm.bwd.kernel" not in trace.snapshot()["counters"]


def test_plain_dR_drops_only_the_zero_step():
    """dR over hs shifted by a step, without the zero step 0 term, is the
    contraction with the zero state prepended."""
    G, L, B, H = 2, 6, 4, 3
    x_proj, mask, R = _inputs(G, L, B, H)
    hs, _, gates, c = lstm_recurrence_fwd(x_proj, mask, R, residuals=True)
    dhs, dhf = _cotangents(G, L, B, H, "both")
    dgates, dR = lstm_recurrence_bwd(gates, c, hs, R, mask, dhs, dhf)
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    torch.testing.assert_close(
        dR, torch.einsum("glbh,glbk->ghk", h_prev, dgates),
        rtol=1e-12, atol=1e-12)


def _no_build(*a, **k):
    raise AssertionError("the library was built")


def _fake_args(G=2, L=3, B=4, H=5, dtype=torch.float32, **over):
    """The kernel's arguments as fake CUDA tensors (no card needed);
    ``over``: name -> (shape, stride or None, dtype or None) of one."""
    cuda = torch.device("cuda")
    shapes = {"gates": (G, L, B, 4 * H), "c": (G, L, B, H),
              "hs": (G, L, B, H), "R": (G, H, 4 * H), "mask": (G, L, B),
              "dhs": (G, L, B, H), "dhf": (G, B, H)}
    args = {}
    for name, shape in shapes.items():
        kind = torch.bool if name == "mask" else dtype
        stride = None
        if name in over:
            shape, stride, new_kind = over[name]
            kind = new_kind or kind
        args[name] = (torch.empty(shape, dtype=kind, device=cuda)
                      if stride is None else
                      torch.empty_strided(shape, stride, dtype=kind,
                                          device=cuda))
    return args


@pytest.mark.parametrize("over,error,match", [
    ({"R": ((2, 5, 20), (100, 1, 5), None)}, ValueError,
     "R is not contiguous"),
    ({"dhs": ((2, 3, 4, 5), (60, 20, 1, 4), None)}, ValueError,
     "dhs is not contiguous"),
    ({"gates": ((2, 3, 4, 20), None, torch.float64)}, TypeError,
     "gates is torch.float64"),
    ({"dhf": ((2, 4, 5), None, torch.bfloat16)}, TypeError,
     "dhf is torch.bfloat16"),
    ({"mask": ((2, 3, 4), None, torch.uint8)}, TypeError,
     "mask is torch.uint8"),
    ({"gates": ((2, 3, 4, 19), None, None)}, ValueError,
     r"gates \(2, 3, 4, 19\) does not match"),
    ({"R": ((1, 5, 20), None, None)}, ValueError, "R .* does not match"),
    ({"mask": ((2, 2, 4), None, None)}, ValueError, "mask .* does not match"),
    ({"dhf": ((2, 3, 5), None, None)}, ValueError, "dhf .* does not match"),
])
def test_kernel_wrapper_checks_before_any_build(monkeypatch, over, error,
                                                match):
    monkeypatch.setattr(_build, "load", _no_build)
    with FakeTensorMode():
        with pytest.raises(error, match=match):
            lstm_recurrence_bwd_kernel(**_fake_args(**over))


def test_kernel_wrapper_refuses_a_wide_lstm_and_cpu_tensors(monkeypatch):
    monkeypatch.setattr(_build, "load", _no_build)
    with FakeTensorMode():
        with pytest.raises(ValueError, match="H=513 outside 1..512"):
            lstm_recurrence_bwd_kernel(**_fake_args(G=1, L=2, B=2, H=513))
        # valid arguments, in either dtype, get as far as the build
        for dtype in (torch.float32, torch.bfloat16):
            with pytest.raises(AssertionError,
                               match="the library was built"):
                lstm_recurrence_bwd_kernel(**_fake_args(dtype=dtype))
        with pytest.raises(TypeError, match="hs float32 or bfloat16"):
            lstm_recurrence_bwd_kernel(**_fake_args(dtype=torch.float64))
        args = _fake_args()
        args["c"] = torch.empty(args["c"].shape)        # one on the CPU
        with pytest.raises(ValueError, match="c on cpu, needs hs's CUDA"):
            lstm_recurrence_bwd_kernel(**args)
    x_proj, mask, R = _inputs(1, 3, 2, 4, dtype=torch.float32)
    hs, _, gates, c = lstm_recurrence_fwd(x_proj, mask, R, residuals=True)
    dhs, dhf = _cotangents(1, 3, 2, 4, "both", torch.float32)
    with pytest.raises(ValueError, match="gates on cpu, needs hs's CUDA"):
        lstm_recurrence_bwd_kernel(gates, c, hs, R, mask, dhs, dhf)


def test_kernel_counter_counts_only_while_a_profile_runs(monkeypatch):
    """The wrapper's launch count always; ``lstm.bwd.kernel`` only under a
    profile.  The library is a stand-in that launches nothing, on CPU
    tensors past the checks."""
    calls = []

    def entry(*args):
        calls.append(args[7:11])        # G, L, B, H
        return 0

    lib = SimpleNamespace(icl_lstm_recurrence_bwd_f32=entry,
                          icl_lstm_recurrence_bwd_bf16=entry)
    monkeypatch.setattr(_build, "load", lambda *a: lib)
    monkeypatch.setattr(lr, "_check_bwd", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    G, L, B, H = 2, 3, 4, 5
    x_proj, mask, R = _inputs(G, L, B, H, dtype=torch.float32)
    hs, _, gates, c = lstm_recurrence_fwd(x_proj, mask, R, residuals=True)
    dhs, dhf = _cotangents(G, L, B, H, "both", torch.float32)
    n0 = lstm_recurrence.bwd.launches
    lstm_recurrence_bwd_kernel(gates, c, hs, R, mask, dhs, dhf)
    assert lstm_recurrence.bwd.launches == n0 + 1
    assert "lstm.bwd.kernel" not in trace.snapshot()["counters"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        lstm_recurrence_bwd_kernel(gates, c, hs, R, mask, dhs, dhf)
        lstm_recurrence_bwd_kernel(gates, c, hs, R, mask, dhs, dhf)
    assert lstm_recurrence.bwd.launches == n0 + 3
    assert trace.snapshot()["counters"]["lstm.bwd.kernel"] == 2
    assert calls == [(G, L, B, H)] * 3
    # the bf16 mode counts apart, in the same trace counter
    n1 = lstm_recurrence.bwd_bf16.launches
    bf = [t.bfloat16() if t.is_floating_point() else t
          for t in (gates, c, hs, R, mask, dhs, dhf)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        lstm_recurrence_bwd_kernel(*bf)
    assert lstm_recurrence.bwd_bf16.launches == n1 + 1
    assert lstm_recurrence.bwd.launches == n0 + 3
    assert trace.snapshot()["counters"]["lstm.bwd.kernel"] == 3
    # empty inputs return before the library is loaded
    monkeypatch.setattr(_build, "load", _no_build)
    dg, dR = lstm_recurrence_bwd_kernel(gates[:, :0], c[:, :0], hs[:, :0],
                                        R, mask[:, :0], dhs[:, :0], dhf)
    assert dg.shape == (G, 0, B, 4 * H) and not dR.any()
    assert lstm_recurrence.bwd.launches == n0 + 3
