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
from icl_torch.ops.grid_head import grid_head

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
