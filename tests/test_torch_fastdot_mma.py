"""The fast dot's tensor-core redesign (the bf16 mode of K1/K2 and K9), on
the CPU.

* The plain versions that the card holds ``icl_grid_head_bf16dot`` and
  ``icl_affinity_rank_bf16dot`` to, against the JAX package's Pallas
  kernel with ``fast_dot`` (interpret mode, as its own CPU tests run it)
  at the shapes where the tensor-core kernel meets an edge: K no multiple
  of 16, K < 16, O = 1, 3 and 8 (N padded to 8), A and B off the warp
  tile of 4 (8) mentions x 16 (8) boxes, and a ranked image with no valid
  box.  Gate: 1e-5 * max(1, max |jax|), the f32 gate.
* The fragment layout the kernel uses (``csrc/grid_head_tile.cuh``: a
  lane's four k's consecutive, slots 2t, 2t + 1 and 8 + 2t, 9 + 2t),
  emulated in numpy: one m16n8k16 product over the dealt slots is the dot.
* :func:`~icl_torch.ops.grid_head.dot_plan`, the launch the wrapper asks
  for (pure Python, the header's ``plan_dot`` mirrored), and the rule by
  which it leaves small grids to the FMA form.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from icl.models.affinity import rank_boxes as jax_rank_boxes
from icl.ops.grid_head import grid_head_pallas
from icl_torch.ops import grid_head as gh
from icl_torch.ops.affinity_rank import affinity_rank
from icl_torch.ops.grid_head import DotPlan, dot_plan, grid_head

GATE = 1e-5


def _gate(want) -> float:
    return GATE * max(1.0, float(np.abs(want).max()))


def _inputs(G, A, B, K, O, seed):
    rng = np.random.default_rng(seed)
    X, Y, b1, W2, b2 = [rng.normal(size=s).astype(np.float32)
                        for s in ((G, A, K), (G, B, K), (K,), (K, O), (O,))]
    return X, Y, b1, (W2 / np.sqrt(K)).astype(np.float32), b2


def _jax_fast_dot(args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(grid_head_pallas(*map(jnp.asarray, args),
                                           fast_dot=True))


@pytest.mark.parametrize("G,A,B,K,O", [
    (2, 9, 17, 24, 1), (2, 5, 8, 72, 3), (1, 17, 33, 72, 8),
    (3, 4, 3, 8, 4), (2, 6, 5, 40, 2), (1, 3, 20, 72, 6)])
def test_fast_dot_edges_match_the_jax_kernel(G, A, B, K, O):
    args = _inputs(G, A, B, K, O, seed=K + O)
    want = _jax_fast_dot(args)
    got = grid_head(*map(torch.from_numpy, args), fast_dot=True).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= _gate(want)


@pytest.mark.parametrize("G,A,B,K,empty_image", [
    (2, 9, 8, 24, True), (3, 5, 17, 72, True), (1, 3, 6, 40, False),
    (2, 17, 33, 8, True)])
def test_fast_dot_rank_edges_match_jax(G, A, B, K, empty_image):
    args = _inputs(G, A, B, K, 2, seed=A + B)
    valid = np.random.default_rng(K).random((G, B)) < 0.7
    valid[:, 0] = True
    if empty_image:
        valid[-1] = False
    want = np.asarray(jax_rank_boxes(jnp.asarray(_jax_fast_dot(args)),
                                     jnp.asarray(valid)))
    got = affinity_rank(*map(torch.from_numpy, args),
                        torch.from_numpy(valid), fast_dot=True).numpy()
    assert np.abs(got - want).max() <= _gate(want)
    if empty_image:
        assert not got[-1].any()
    assert not got[np.broadcast_to(~valid[:, None, :], got.shape)].any()


def _slot_k(t: int, slot: int) -> int:
    """The k (of 16 in a chunk) that lane group t's fragment slot holds."""
    return 4 * t + (slot % 8) - 2 * t + (2 if slot >= 8 else 0)


def test_the_fragment_slots_deal_each_k_once_and_keep_the_dot():
    """m16n8k16 row.col: lane l = 4 g + t holds A rows g and g + 8 at k
    slots 2t, 2t + 1 (a0, a1) and 8 + 2t, 9 + 2t (a2, a3), B column g at
    the same slots (b0, b1).  The kernel puts k0 + 4t + {0, 1} and
    + {2, 3} there; over all lanes that is every k once, so the product
    over slots is the dot over k."""
    slots = {(t, s): _slot_k(t, s) for t in range(4)
             for s in (2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t)}
    assert sorted(slots.values()) == list(range(16))
    for t in range(4):
        assert [slots[(t, s)] for s in (2 * t, 2 * t + 1, 8 + 2 * t,
                                        9 + 2 * t)] == [4 * t + j
                                                        for j in range(4)]
    rng = np.random.default_rng(0)
    h, w = rng.normal(size=(16, 16)), rng.normal(size=(16, 8))
    a = np.zeros((16, 16))
    b = np.zeros((16, 8))
    for (t, s), k in slots.items():
        a[:, s], b[s] = h[:, k], w[k]
    assert np.allclose(a @ b, h @ w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("G,A,B,K,O,rank,want", [
    # the relation batch: 2 groups of 8 mentions an image, one box tile;
    # the K split toward filling the card, 8 warps a block at most
    (64, 16, 16, 800, 4, False,
     DotPlan(True, 1, 16, 8, 1, 128, 256, 71168)),
    # the affinity batch: two box tiles side by side, 4 slices; the
    # ranking adds its scores
    (64, 16, 32, 1024, 2, False,
     DotPlan(True, 1, 16, 4, 2, 128, 256, 81920)),
    (64, 16, 32, 1024, 2, True,
     DotPlan(True, 1, 16, 4, 2, 128, 256, 82944)),
    # 8 mentions x 8 boxes where B <= 8
    (2048, 9, 8, 72, 3, False, DotPlan(True, 1, 8, 1, 1, 4096, 32, 5888)),
    # K % 4 != 0: 4-byte loads; more box tiles than 8: no split, turns
    (64, 7, 300, 798, 4, True,
     DotPlan(True, 0, 16, 1, 8, 64, 256, 80768)),
    # a served relation request: too little work for the tensor cores
    (1, 16, 16, 800, 4, False, DotPlan(False, 1, 16, 8, 1, 2, 256, 71168))])
def test_dot_plan(G, A, B, K, O, rank, want):
    assert dot_plan(G, A, B, K, O, True, rank) == want


@pytest.mark.parametrize("kind,A,B,K,O,G_fma,G_mma", [
    ("relation", 16, 16, 800, 4, 32, 48), ("affinity", 16, 32, 1024, 2, 16, 32),
    ("rank", 16, 32, 1024, 2, 16, 32)])
def test_the_tensor_cores_take_the_grids_where_they_win(kind, A, B, K, O,
                                                        G_fma, G_mma):
    """DOT_WORK sits between the largest grid the FMA form served faster
    on the card and the smallest the tensor cores did (fastdot_times.py
    --sizes): G A B K (4 + O) below it goes to the FMA form."""
    rank = kind == "rank"
    assert not dot_plan(G_fma, A, B, K, O, True, rank).mma
    assert dot_plan(G_mma, A, B, K, O, True, rank).mma
    assert G_fma * A * B * K * (4 + O) < gh.DOT_WORK <= \
        G_mma * A * B * K * (4 + O)


@pytest.mark.parametrize("G", [1, 3, 8, 64, 200])
@pytest.mark.parametrize("A,B,K", [(1, 1, 1), (16, 16, 800), (17, 9, 24),
                                   (5, 100, 1024), (32, 32, 50)])
def test_dot_plan_fits_a_block(G, A, B, K):
    for rank in (False, True):
        p = dot_plan(G, A, B, K, 4, True, rank)
        assert p.bt == (8 if B <= 8 else 16)
        assert p.threads == 32 * p.tasks * p.ksplit <= 32 * gh.DOT_WARPS
        assert p.tasks == min(-(-B // p.bt), gh.DOT_WARPS)
        assert 1 <= p.ksplit <= max(1, -(-K // gh.DOT_K))
        assert p.blocks == G * -(-A // gh.DOT_MENTIONS)
        assert p.mma == (p.smem <= gh.DOT_SMEM
                         and G * A * B * K * 8 >= gh.DOT_WORK)
        # X, Y and b1 aligned but K % 4 != 0, or one of them not: 4-byte
        assert dot_plan(G, A, B, K, 4, False, rank).vec == 0
        assert p.vec == int(K % 4 == 0)


def test_a_block_beyond_shared_memory_takes_the_fma_form():
    plan = dot_plan(64, 8, 16, 20000, 4, True)
    assert plan.smem > gh.DOT_SMEM and not plan.mma
    assert dot_plan(64, 8, 16, 2048, 4, True).mma
