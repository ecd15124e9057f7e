"""icl_torch grid head (CPU: the wrapper's plain version) vs the JAX head.

The same numpy inputs go to icl.ops.grid_head's XLA reference and its
Pallas kernel (interpret mode, as tests/unit/test_grid_head.py runs it) and
to the port.  f32 tolerance 1e-5: the sums over K run in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from icl.ops.grid_head import grid_head_pallas, grid_head_reference
from icl_torch.ops import _build
from icl_torch.ops import grid_head as gh
from icl_torch.ops.grid_head import (COL_TILES, MAX_WARPS, RANK_COL_WARPS,
                                     RANK_WARPS, KernelNoGradError, aligned16,
                                     check_no_grad, grid_head, launch_plan,
                                     wants_grad)

# (G, A, B, K, O): the Pallas flat path (one tile per image), odd sizes,
# the tiled path (B=130 > 128), and the relation head width K=800, O=4
SHAPES = [(2, 8, 16, 32, 4), (1, 5, 7, 24, 2), (3, 9, 130, 16, 2),
          (2, 16, 16, 800, 4)]


def _inputs(G, A, B, K, O, seed=0):
    """Unit-normal X, Y, b1, b2; W2 at the lecun_normal scale of the
    model's head_out kernel (std 1/sqrt(K)), so logits are O(1)."""
    rng = np.random.default_rng(seed)
    X, Y, b1, W2, b2 = [rng.normal(size=s).astype(np.float32)
                        for s in ((G, A, K), (G, B, K), (K,), (K, O), (O,))]
    return X, Y, b1, (W2 / np.sqrt(K)).astype(np.float32), b2


def _jax_head(oracle, args):
    jargs = [jnp.asarray(a) for a in args]
    if oracle == "reference":
        return np.asarray(grid_head_reference(*jargs))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(grid_head_pallas(*jargs))


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("G,A,B,K,O", SHAPES)
def test_grid_head_matches_jax(G, A, B, K, O, oracle):
    args = _inputs(G, A, B, K, O)
    want = _jax_head(oracle, args)
    got = grid_head(*[torch.from_numpy(a) for a in args]).numpy()
    assert got.shape == (G, A, B, O)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("G,A,B", [(0, 4, 4), (2, 0, 4), (2, 4, 0)])
def test_empty_grid_is_zeros(G, A, B):
    args = _inputs(G, A, B, 8, 4)
    want = _jax_head("pallas", args)
    got = grid_head(*[torch.from_numpy(a) for a in args]).numpy()
    assert got.shape == want.shape == (G, A, B, 4)
    assert not got.any()


def test_unsupported_device_raises():
    args = [torch.empty(s, device="meta")
            for s in ((1, 2, 8), (1, 2, 8), (8,), (8, 4), (4,))]
    with pytest.raises(ValueError, match="unsupported device"):
        grid_head(*args)


# shapes that stress the CUDA kernel's tiling (4 x 4 and 2 x 2 register
# tiles of cells, 16-byte chunks of K): ragged A and B, K no multiple of 4,
# every head width; the plain version carries the same contract on the CPU
TILE_EDGE_SHAPES = [(1, 5, 7, 30, 1), (2, 7, 9, 50, 2), (2, 9, 17, 800, 3),
                    (1, 17, 20, 1024, 4), (2, 20, 33, 50, 8),
                    (1, 33, 5, 30, 4)]


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("G,A,B,K,O", TILE_EDGE_SHAPES)
def test_grid_head_matches_jax_at_tile_edges(G, A, B, K, O, oracle):
    args = _inputs(G, A, B, K, O, seed=1)
    want = _jax_head(oracle, args)
    got = grid_head(*[torch.from_numpy(a) for a in args]).numpy()
    assert got.shape == (G, A, B, O)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# (G, A, B, K, O, aligned) -> (vec, ksplit, blocks)
PLANS = [
    # the training batches: enough 4 x 4 tiles to fill the card, no K split
    ((64, 16, 16, 800, 4, True), (1, 1, 256)),
    ((64, 16, 32, 1024, 2, True), (1, 1, 512)),
    ((64, 32, 32, 800, 4, True), (1, 1, 1024)),
    # served requests: few tiles, K split over a block's warps, at most one
    # 128-wide pass each (800 = 7 passes, 1024 = 8)
    ((8, 16, 16, 800, 4, True), (1, 7, 128)),
    ((1, 16, 16, 800, 4, True), (1, 7, 16)),
    ((4, 16, 32, 1024, 2, True), (1, 8, 128)),
    ((64, 8, 8, 800, 4, True), (1, 5, 256)),
    # ragged tiles round up
    ((1, 17, 20, 1024, 4, True), (1, 8, 25)),
    # K % 4 != 0, a head width without a 4 x 4 form, or an operand that is
    # not 16-byte aligned: 2 x 2 tiles; only the last two lose the wide loads
    ((2, 5, 7, 30, 3, True), (0, 1, 6)),
    ((2, 9, 17, 800, 3, True), (1, 7, 90)),
    ((64, 16, 16, 800, 4, False), (0, 1, 1024)),
    ((8, 16, 16, 800, 4, False), (0, 3, 512)),
    ((1, 1, 1, 4, 2, True), (1, 1, 1)),
]


@pytest.mark.parametrize("call,want", PLANS)
def test_launch_plan_table(call, want):
    plan = launch_plan(*call)
    assert tuple(plan) == want
    G, A, B, K, O, _ = call
    tile = 4 if plan.vec and O in (2, 4) else 2
    col_tiles = -(-B // tile)
    # a block holds one column tile when K is split, else up to COL_TILES
    col_warps = 1 if plan.ksplit > 1 else min(col_tiles, COL_TILES)
    assert 1 <= plan.ksplit * col_warps <= MAX_WARPS
    assert plan.blocks == G * -(-A // tile) * -(-col_tiles // col_warps)
    assert plan.ksplit <= -(-K // (32 * (4 if plan.vec else 1)))


# the box ranking's plan (whole_rows): (G, A, B, K, O, aligned) -> (vec,
# ksplit, blocks); a block owns the whole rows of a 4-mention tile
RANK_PLANS = [
    # the affinity batch: enough tiles, no split, 8 column tiles side by side
    ((64, 16, 32, 1024, 2, True), (1, 1, 256)),
    ((64, 16, 20, 1024, 2, True), (1, 1, 256)),
    # a served request: 16 blocks; 8 column warps leave room for 2 k slices
    ((4, 16, 32, 1024, 2, True), (1, 2, 16)),
    ((1, 16, 32, 1024, 2, True), (1, 2, 4)),
    # few boxes: fewer column warps, more slices (at most one pass each)
    ((4, 16, 8, 1024, 2, True), (1, 8, 16)),
    ((8, 16, 20, 1024, 2, True), (1, 3, 32)),
    ((2, 12, 1, 1024, 2, True), (1, 8, 6)),
    # more boxes than 8 column tiles: the block takes them in turns
    ((2, 12, 100, 1024, 2, True), (1, 2, 6)),
    ((2, 17, 33, 1024, 2, True), (1, 2, 10)),
    # K % 4 != 0 or an unaligned operand: 4-byte loads, still 4 x 4 tiles
    ((5, 16, 32, 1022, 2, True), (0, 2, 20)),
    ((4, 16, 32, 1024, 2, False), (0, 2, 16)),
    ((64, 17, 33, 1024, 3, True), (1, 1, 320)),
    ((1, 1, 1, 30, 2, True), (0, 1, 1)),
]


@pytest.mark.parametrize("call,want", RANK_PLANS)
def test_rank_launch_plan_table(call, want):
    plan = launch_plan(*call, whole_rows=True)
    assert tuple(plan) == want
    G, A, B, K, O, _ = call
    col_warps = min(-(-B // 4), RANK_COL_WARPS)
    assert 1 <= plan.ksplit * col_warps <= RANK_WARPS
    assert plan.blocks == G * -(-A // 4)
    assert plan.ksplit <= -(-K // (32 * (4 if plan.vec else 1)))
    # the grid head's own plan is untouched by the new argument
    assert launch_plan(*call) == launch_plan(*call, whole_rows=False)


@pytest.mark.parametrize("grad_on,requires,wants", [
    (True, (False, True, False), True), (True, (False, False), False),
    (False, (True, True), False), (True, (), False)])
def test_wants_grad_is_grad_mode_and_an_input_that_requires_it(
        grad_on, requires, wants):
    assert wants_grad(grad_on, requires) is wants


def test_a_forward_only_kernel_refuses_a_call_autograd_would_record():
    """The guard the CUDA wrappers run before their launch, reached here
    with CPU tensors: a named error under grad mode, none under
    ``inference_mode`` or ``no_grad`` or without a grad-requiring input."""
    X = torch.zeros(2, 3, 4)
    W = torch.zeros(4, 2, requires_grad=True)
    check_no_grad("grid_head", X, X)
    with pytest.raises(KernelNoGradError, match="grid_head.*inference_mode"):
        check_no_grad("grid_head", X, W)
    with torch.inference_mode():
        check_no_grad("grid_head", X, W)
    with torch.no_grad():
        check_no_grad("affinity_rank", X, W)
    # both wrappers run it on their CUDA path, after the argument checks
    import inspect
    from icl_torch.ops import affinity_rank as ar
    assert 'check_no_grad("grid_head"' in inspect.getsource(gh.grid_head)
    assert 'check_no_grad("affinity_rank"' in inspect.getsource(
        ar.affinity_rank)
    # and the CPU path stays differentiable
    out = grid_head(X, X, torch.zeros(4), W, torch.zeros(2))
    out.sum().backward()
    assert W.grad is not None


def test_an_offset_view_is_not_aligned_and_takes_the_scalar_form():
    base = torch.zeros(4 * 16 * 800 + 1)
    whole, view = base[:-1].view(4, 16, 800), base[1:].view(4, 16, 800)
    assert view.is_contiguous() and aligned16(whole)
    assert not aligned16(whole, view)
    assert launch_plan(4, 16, 16, 800, 4, aligned16(whole)).vec == 1
    assert launch_plan(4, 16, 16, 800, 4, aligned16(whole, view)).vec == 0
    # a view four floats in is aligned again
    assert aligned16(torch.zeros(12)[4:])


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh renames every library, so it rebuilds."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "b.cu").write_text("// no include\n")
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    before = {n: _build.library_path(n) for n in ("a", "b")}
    assert before["a"] != before["b"]
    assert before == {n: _build.library_path(n) for n in ("a", "b")}
    (tmp_path / "h.cuh").write_text("// v2\n")
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert after["a"] != before["a"] and after["b"] != before["b"]
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build.library_path("a") != after["a"]
    assert _build.library_path("b") == after["b"]
    assert _build.library_path("a", ("-DX",)) != _build.library_path("a")


def test_the_real_header_enters_the_real_library_names():
    names = [p.name for p in _build.SRC_DIR.glob("*.cuh")]
    assert "grid_head_tile.cuh" in names
    assert _build.library_path("grid_head").parent == _build.BUILD_DIR
