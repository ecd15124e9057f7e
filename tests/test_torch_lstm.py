"""icl_torch LSTM recurrence and LSTM/BiLSTM modules vs the JAX package.

Same numpy inputs and weights on both sides.  On the CPU the port's
recurrence wrapper runs its plain version; the JAX side runs
icl.models.rnn (the lax.scan) and icl.ops.lstm_kernel's Pallas
recurrence in interpret mode.  f32 tolerance 1e-5.  Lengths are ragged and
include 0 (a row that never updates: all-zero outputs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from icl.models.rnn import LSTM as JaxLSTM
from icl.models.rnn import BiLSTM as JaxBiLSTM
from icl.models.rnn import lstm_recurrence as jax_lstm_recurrence
from icl.ops.lstm_kernel import bilstm_apply_pallas
from icl_torch.models.rnn import LSTM, BiLSTM
from icl_torch.ops.lstm_recurrence import lstm_recurrence

TOL = dict(rtol=1e-5, atol=1e-5)
B, D, H = 6, 12, 8


def _lengths(L):
    return np.array([L, 0, 1, L // 2, L - 1, 3], np.int32)[:B]


def _x(L, seed=1):
    return np.random.default_rng(seed).normal(size=(B, L, D)).astype(
        np.float32)


def _load(module, params):
    module.load_state_dict({
        ".".join(p.key for p in path): torch.from_numpy(np.array(leaf))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]})
    return module


@pytest.mark.parametrize("L", [9, 16])
def test_recurrence_matches_jax(L):
    rng = np.random.default_rng(L)
    G = 2
    x_proj = rng.normal(size=(G, L, B, 4 * H)).astype(np.float32)
    R = (rng.normal(size=(G, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    t = np.arange(L)[:, None]
    lengths = _lengths(L)
    mask = np.stack([t < lengths, (L - 1 - t) < lengths])      # [G, L, B]
    hs_j, fin_j = jax_lstm_recurrence(
        jnp.asarray(x_proj.transpose(1, 0, 2, 3)), jnp.asarray(R),
        jnp.asarray(mask.transpose(1, 0, 2)))                  # time-major
    hs, fin = lstm_recurrence(torch.from_numpy(x_proj),
                              torch.from_numpy(mask), torch.from_numpy(R))
    np.testing.assert_allclose(hs.numpy(),
                               np.asarray(hs_j).transpose(1, 0, 2, 3), **TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(fin_j), **TOL)
    assert not hs.numpy()[:, :, 1].any()          # the length-0 row


def _jax_bilstm(L):
    x, lengths = jnp.asarray(_x(L)), jnp.asarray(_lengths(L))
    m = JaxBiLSTM(hidden=H)
    params = m.init(jax.random.PRNGKey(L), x, lengths)["params"]
    return m, params, x, lengths


@pytest.mark.parametrize("L", [9, 16])
def test_bilstm_matches_jax_scan(L):
    m, params, x, lengths = _jax_bilstm(L)
    seq_j, fin_j = m.apply({"params": params}, x, lengths)
    port = _load(BiLSTM(D, H), params)
    seq, fin = port(torch.from_numpy(_x(L)), torch.from_numpy(_lengths(L)))
    np.testing.assert_allclose(seq.detach().numpy(), np.asarray(seq_j),
                               **TOL)
    np.testing.assert_allclose(fin.detach().numpy(), np.asarray(fin_j),
                               **TOL)


@pytest.mark.parametrize("L", [9, 16])
def test_bilstm_matches_jax_pallas_interpret(L):
    """The Pallas recurrence zero-pads rows past the length where the scan
    carries the state through; compare the valid positions, as
    tests/unit/test_lstm_kernel.py does, and the final states."""
    _, params, x, lengths = _jax_bilstm(L)
    with pltpu.force_tpu_interpret_mode():
        seq_j, fin_j = bilstm_apply_pallas(x, lengths, params, hidden=H)
    port = _load(BiLSTM(D, H), params)
    seq, fin = port(torch.from_numpy(_x(L)), torch.from_numpy(_lengths(L)))
    seq, seq_j = seq.detach().numpy(), np.asarray(seq_j)
    for b, n in enumerate(_lengths(L)):
        np.testing.assert_allclose(seq[b, :n], seq_j[b, :n], **TOL)
    np.testing.assert_allclose(fin.detach().numpy(), np.asarray(fin_j),
                               **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_matches_jax(reverse):
    L = 9
    x, lengths = jnp.asarray(_x(L, seed=2)), jnp.asarray(_lengths(L))
    m = JaxLSTM(hidden=H, reverse=reverse)
    params = m.init(jax.random.PRNGKey(3), x, lengths)["params"]
    out_j, fin_j = m.apply({"params": params}, x, lengths)
    port = _load(LSTM(D, H, reverse=reverse), params)
    out, fin = port(torch.from_numpy(_x(L, seed=2)),
                    torch.from_numpy(_lengths(L)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **TOL)
    np.testing.assert_allclose(fin.detach().numpy(), np.asarray(fin_j),
                               **TOL)
