"""``--compute_dtype bf16`` in the port vs the JAX package (CPU).

The same numpy inputs go to both sides.  On the CPU the port's kernel
wrappers run their plain versions; the JAX side's Pallas kernels run in
interpret mode, as tests/test_torch_grid_head.py runs them.  The gates:

* the grid head's fast-dot mode (K1/K2) and the box ranking over it (K9):
  1e-5 * max(1, max |jax|), the f32 gate.  Both sides round the same
  activation and W2 to bf16 and sum exact products in f32; only the order
  of the sum differs.
* the bf16 recurrence, forward: 4 bf16 units in the last place of
  max |jax| (a unit is 2 ** (floor(log2 max |jax|) - 7)); backward
  (dx_proj, dR): 8.  The port rounds after every eager op, as PyTorch's
  bf16 ops do; XLA's CPU backend keeps f32 between some fused bf16 ops, so
  the two cannot agree bit for bit, and a unit's difference in a rounded
  value travels down the steps (measured: up to 2.5 units forward at
  L = 32, 3.8 backward).
* the bf16 recurrence kernel's order of the h . R sum (chunks of 16 k's,
  one f32 sum each, the chunks added in k order: its tensor-core phase A),
  emulated in a copy of the plain step: 4 bf16 units of max |plain|, the
  card's gate (chip_smoke.py BF16_REC_ULPS).
* whole models and one train step: the port's distance to the JAX bf16
  result is at most twice the JAX package's own bf16-vs-f32 distance on the
  same batch, plus the f32 gate (probabilities, the loss) or one bf16 unit
  of the largest gradient (the gradients of the step, pooled).
* the planted convergence gate: relation in bf16 within 4 points of f32
  (tests/integration/test_convergence.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from icl.cli.export import flatten_params
from icl.data.imagebatch import RelationBatcher
from icl.data.pipeline import load_relation_dataset
from icl.models import AffinityModel as JaxAffinityModel
from icl.models import RelationModel as JaxRelationModel
from icl.models.affinity import rank_boxes as jax_rank_boxes
from icl.models.relation import gather_mention_reps as jax_gather_reps
from icl.models.rnn import LSTM as JaxLSTM
from icl.models.rnn import BiLSTM as JaxBiLSTM
from icl.models.rnn import lstm_recurrence as jax_lstm_recurrence
from icl.ops.grid_head import grid_head_pallas
from icl.train import steps as jax_steps
from icl.train.state import create_train_state as jax_create_train_state
from icl_torch.data.imagebatch import with_box_dtype
from icl_torch.models.affinity import AffinityModel
from icl_torch.models.relation import RelationModel
from icl_torch.ops.affinity_rank import affinity_rank, affinity_rank_reference
from icl_torch.ops.grid_head import grid_head, grid_head_reference
from icl_torch.ops.lstm_recurrence import lstm_recurrence
from icl_torch.train import steps

GATE = 1e-5
BF16 = jnp.bfloat16
LSTM_H, HEAD_H = 8, 16


def _f32_gate(want) -> float:
    return GATE * max(1.0, float(np.abs(want).max()))


def _ulp(want) -> float:
    """A bf16 unit in the last place of max |want|."""
    return 2.0 ** (np.floor(np.log2(float(np.abs(want).max()))) - 7)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _within_twice_jax(port, jax_bf16, jax_f32, what):
    """max |port - jax bf16| <= 2 max |jax bf16 - jax f32| + the f32 gate."""
    port, jb, jf = _np(port), _np(jax_bf16), _np(jax_f32)
    assert port.shape == jb.shape, (what, port.shape, jb.shape)
    err = float(np.abs(port - jb).max())
    own = float(np.abs(jb - jf).max())
    assert err <= 2 * own + _f32_gate(jb), (what, err, own)


# --- (a) the grid head's fast-dot mode -------------------------------------

def _head_inputs(G, A, B, K, O, seed=0):
    rng = np.random.default_rng(seed)
    X, Y, b1, W2, b2 = [rng.normal(size=s).astype(np.float32)
                        for s in ((G, A, K), (G, B, K), (K,), (K, O), (O,))]
    return X, Y, b1, (W2 / np.sqrt(K)).astype(np.float32), b2


def _jax_fast_dot(args):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(grid_head_pallas(*map(jnp.asarray, args),
                                           fast_dot=True))


# (G, A, B, K, O): the flat Pallas path (one tile per image) and, with
# Ap * Bp * K * 4 > 4 MB, the tiled one (8 x 256 x 520 x 4)
@pytest.mark.parametrize("G,A,B,K,O", [(2, 8, 16, 32, 4), (3, 5, 7, 24, 2),
                                       (2, 16, 16, 800, 4),
                                       (1, 8, 130, 520, 2),
                                       (1, 8, 130, 520, 4)])
def test_fast_dot_grid_head_matches_the_jax_kernel(G, A, B, K, O):
    args = _head_inputs(G, A, B, K, O)
    want = _jax_fast_dot(args)
    targs = [torch.from_numpy(a) for a in args]
    got = grid_head(*targs, fast_dot=True).numpy()
    assert np.abs(got - want).max() <= _f32_gate(want)
    # the rounding shows: the f32 mode lies farther from the fast dot
    f32 = grid_head(*targs).numpy()
    assert np.abs(f32 - want).max() > 10 * np.abs(got - want).max()


def test_fast_dot_rounds_the_activation_after_folding_b1():
    """relu((X + b1) + Y) in that order, then bf16: the plain version's
    activation is that of the JAX kernel, whose wrapper folds b1 into X."""
    X, Y, b1, W2, b2 = (torch.from_numpy(a)
                        for a in _head_inputs(1, 3, 4, 64, 2, seed=5))
    h = torch.relu((X + b1)[:, :, None] + Y[:, None])
    want = torch.einsum("gabk,ko->gabo", h.bfloat16().float(),
                        W2.bfloat16().float()) + b2
    assert torch.allclose(grid_head_reference(X, Y, b1, W2, b2, True), want,
                          rtol=0, atol=1e-6)


# --- (b) the box ranking over the fast-dot logits ---------------------------

@pytest.mark.parametrize("G,A,B,K,empty_image", [(2, 8, 16, 32, False),
                                                 (3, 6, 9, 16, True),
                                                 (2, 17, 33, 24, True)])
def test_fast_dot_rank_matches_jax_over_the_fast_dot_logits(G, A, B, K,
                                                            empty_image):
    args = _head_inputs(G, A, B, K, 2, seed=G + A)
    rng = np.random.default_rng(A)
    valid = rng.random((G, B)) < 0.8
    valid[:, 0] = True
    if empty_image:
        valid[-1] = False
    want = np.asarray(jax_rank_boxes(jnp.asarray(_jax_fast_dot(args)),
                                     jnp.asarray(valid)))
    targs = [torch.from_numpy(a) for a in args]
    tvalid = torch.from_numpy(valid)
    got = affinity_rank(*targs, tvalid, fast_dot=True).numpy()
    assert np.abs(got - want).max() <= _f32_gate(want)
    assert torch.equal(affinity_rank_reference(*targs, tvalid, 1, True),
                       torch.from_numpy(got))


# --- (c) the recurrence in bf16 ---------------------------------------------

def _recurrence_problem(L, seed, H=8, B=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, L, B, 4 * H)).astype(np.float32)
    R = (rng.normal(size=(2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    t = np.arange(L)[:, None]
    lengths = np.array([L, 0, 1, L // 2, L - 1, 3])[:B]
    mask = np.stack([t < lengths, (L - 1 - t) < lengths])     # [G, L, B]
    cot = (rng.normal(size=(2, L, B, H)).astype(np.float32),
           rng.normal(size=(2, B, H)).astype(np.float32))
    return x, R, mask, cot


def _jax_recurrence(x, R, mask, cot, dtype):
    """hs, h_final and (dx_proj, dR) of icl.models.rnn.lstm_recurrence in
    ``dtype``, in the port's [G, L, B] layout."""
    def f(a, r):
        return jax_lstm_recurrence(a, r, jnp.asarray(mask.transpose(1, 0, 2)))

    (hs, fin), vjp = jax.vjp(f, jnp.asarray(x.transpose(1, 0, 2, 3), dtype),
                             jnp.asarray(R, dtype))
    dx, dR = vjp((jnp.asarray(cot[0].transpose(1, 0, 2, 3), dtype),
                  jnp.asarray(cot[1], dtype)))
    return (_np(hs).transpose(1, 0, 2, 3), _np(fin),
            _np(dx).transpose(1, 0, 2, 3), _np(dR))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("L", [9, 16])
def test_bf16_recurrence_and_backward_match_the_jax_scan(L, seed):
    x, R, mask, cot = _recurrence_problem(L, seed + L)
    want = _jax_recurrence(x, R, mask, cot, BF16)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    Rt = torch.from_numpy(R).bfloat16().requires_grad_()
    hs, fin = lstm_recurrence(xt, torch.from_numpy(mask), Rt)
    assert hs.dtype == fin.dtype == torch.bfloat16
    torch.autograd.backward([hs, fin], [torch.from_numpy(c).bfloat16()
                                        for c in cot])
    assert xt.grad.dtype == Rt.grad.dtype == torch.bfloat16
    got = (hs, fin, xt.grad, Rt.grad)
    for name, g, w, units in zip(("hs", "h_final", "dx_proj", "dR"), got,
                                 want, (4, 4, 8, 8)):
        err = float(np.abs(_np(g) - w).max())
        assert err <= units * _ulp(w), (name, err / _ulp(w))
    # a row of length 0 never updates: exact zeros in both directions
    assert not _np(hs)[:, :, 1].any()


def test_bf16_backward_casts_f32_cotangents():
    """The reverse loop runs in the residuals' dtype whatever dtype the
    cotangents arrive in, as the reference casts them."""
    from icl_torch.ops.lstm_recurrence import (lstm_recurrence_bwd,
                                               lstm_recurrence_reference)

    x, R, mask, cot = _recurrence_problem(5, 3)
    xt, Rt = torch.from_numpy(x).bfloat16(), torch.from_numpy(R).bfloat16()
    tmask = torch.from_numpy(mask)
    hs, _, gates, c = lstm_recurrence_reference(xt, tmask, Rt, True)
    f32 = lstm_recurrence_bwd(gates, c, hs, Rt, tmask,
                              *map(torch.from_numpy, cot))
    bf = lstm_recurrence_bwd(gates, c, hs, Rt, tmask,
                             *(torch.from_numpy(a).bfloat16() for a in cot))
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b)
               for a, b in zip(f32, bf))


def _chunked_product(h, R):
    """bf16(h . R) in the order of the recurrence kernel's tensor-core
    phase A: each chunk of 16 k's one f32 sum of exact products (one mma
    from a zero accumulator), the chunks added in f32 in k order, the sum
    rounded to bf16 once."""
    acc = torch.zeros(h.shape[0], h.shape[1], R.shape[2])
    for k in range(0, R.shape[1], 16):
        acc = acc + torch.bmm(h[..., k:k + 16].float(),
                              R[:, k:k + 16].float())
    return acc.bfloat16()


def _recurrence_in_chunk_order(x_proj, mask, R):
    """lstm_recurrence_reference(..., residuals=True) in bf16 with its
    product in the kernel's order (:func:`_chunked_product`); every other
    op the plain version's eager bf16 op."""
    G, L, B, H4 = x_proj.shape
    H = H4 // 4
    h = x_proj.new_zeros((G, B, H))
    c = x_proj.new_zeros((G, B, H))
    hs, gates, cs = [], [], []
    for t in range(L):
        z = x_proj[:, t] + _chunked_product(h, R)
        i = torch.sigmoid(z[..., :H])
        f = torch.sigmoid(z[..., H:2 * H])
        g = torch.tanh(z[..., 2 * H:3 * H])
        o = torch.sigmoid(z[..., 3 * H:])
        c_t = f * c + i * g
        h_t = o * torch.tanh(c_t)
        m = mask[:, t, :, None]
        h = torch.where(m, h_t, h)
        c = torch.where(m, c_t, c)
        hs.append(h)
        gates.append(torch.cat([i, f, g, o], dim=-1))
        cs.append(c)
    return (torch.stack(hs, 1), h, torch.stack(gates, 1),
            torch.stack(cs, 1))


@pytest.mark.parametrize("B,H", [(9, 63), (17, 200), (61, 300), (9, 511)])
def test_the_kernels_chunked_sum_order_stays_within_the_bf16_gate(B, H):
    """The bf16 recurrence kernel sums h . R in chunks of 16 products on
    the tensor cores; that order alone, in a copy of the plain step, keeps
    hs, h_final and the residuals within 4 bf16 units of max |plain| of the
    plain version (the card's gate, BF16_REC_ULPS), at G = 2, L = 8, odd
    widths and both cluster sizes' widths."""
    # one intra-op thread: beside the other test workers' load, a thread
    # pool makes these many small ops take 10-90 s instead of one
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _hold_the_chunked_order_to_plain(2, 8, B, H)
    finally:
        torch.set_num_threads(before)


def _hold_the_chunked_order_to_plain(G, L, B, H):
    from icl_torch.ops.lstm_recurrence import lstm_recurrence_reference

    rng = np.random.default_rng(B * 1000 + H)
    x = torch.from_numpy(rng.normal(size=(G, L, B, 4 * H)).astype(
        np.float32)).bfloat16()
    R = torch.from_numpy((rng.normal(size=(G, H, 4 * H)) / np.sqrt(H))
                         .astype(np.float32)).bfloat16()
    lengths = rng.integers(0, L + 1, size=B)
    lengths[0], lengths[-1] = 0, L
    t = np.arange(L)[:, None]
    mask = torch.from_numpy(np.stack([t < lengths, (L - 1 - t) < lengths]))
    got = _recurrence_in_chunk_order(x, mask, R)
    want = lstm_recurrence_reference(x, mask, R, True)
    for name, g, w in zip(("hs", "h_final", "gates", "c"), got, want,
                          strict=True):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= 4 * _ulp(_np(w)), (name, err / _ulp(_np(w)))


# --- (d) whole models --------------------------------------------------------

def _relation_batch(emb, synth_dir):
    ds = load_relation_dataset(synth_dir, "train", emb)
    return next(iter(RelationBatcher(images_per_batch=4,
                                     build_grid=True).batches(ds))).arrays


def _torch(arrays):
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(v)) for k, v in arrays.items()}


def _jax_relation_fused_bf16(params, table, jb):
    """The JAX fused relation model in bf16, composed: on the CPU its
    dispatcher takes the XLA oracle and ignores fast_dot, so the encoder and
    the projections are the model's and the head is the fast-dot Pallas
    kernel in interpret mode."""
    tokens = jb["tokens"]
    I, C, L = tokens.shape
    x = jnp.take(table, tokens.reshape(I * C, L), axis=0)
    enc, _ = JaxBiLSTM(LSTM_H, compute_dtype=BF16).apply(
        {"params": params["caption_bilstm"]}, x, jb["tok_len"].reshape(-1))
    mreps = jax_gather_reps(enc.reshape(I, C, L, -1), jb["m_cap"],
                            jb["m_first"], jb["m_last"])
    W1, b1 = params["head_dense"]["kernel"], params["head_dense"]["bias"]
    R = mreps.shape[-1]
    args = (mreps @ W1[:R], mreps @ W1[R:], b1, params["head_out"]["kernel"],
            params["head_out"]["bias"])
    grid = _jax_fast_dot([np.asarray(a) for a in args])
    pij = np.asarray(jb["pair_ij"])
    logits = grid[np.arange(I)[:, None], pij[..., 0], pij[..., 1]]
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_relation_probs_match_jax(emb, synth_dir, fused):
    arrays = _relation_batch(emb, synth_dir)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    table = jnp.asarray(emb.table)
    params = JaxRelationModel(lstm_hidden=LSTM_H, head_hidden=HEAD_H).init(
        jax.random.PRNGKey(5), table, jb)["params"]

    def jax_probs(dtype):
        model = JaxRelationModel(lstm_hidden=LSTM_H, head_hidden=HEAD_H,
                                 compute_dtype=dtype)
        return np.asarray(jax_steps.make_relation_predict(model.apply)(
            params, table.astype(dtype), jb))

    want_f32 = jax_probs(jnp.float32)
    want = (_jax_relation_fused_bf16(params, table.astype(BF16), jb)
            if fused else jax_probs(BF16))
    model = RelationModel(emb.dim, LSTM_H, HEAD_H, fused=fused,
                          compute_dtype=torch.bfloat16)
    model.load_flat({k: torch.from_numpy(v.copy())
                     for k, v in flatten_params(params).items()})
    got = steps.relation_predict(
        model, torch.from_numpy(emb.table).bfloat16(), _torch(arrays))
    assert got.dtype == torch.float32
    valid = arrays["pair_valid"]
    _within_twice_jax(got.numpy()[valid], want[valid], want_f32[valid],
                      "relation probs")


def _jax_affinity_fused_bf16(phrase_enc, params, table, jb):
    """As :func:`_jax_relation_fused_bf16` for affinity: the bf16 phrase
    encoder and the two projections, then the fast-dot kernel; with the
    ranking over those logits."""
    toks, plen = jb["phrase_tokens"], jb["phrase_len"]
    I, M, L = toks.shape
    x = jnp.take(table, toks.reshape(I * M, L), axis=0)
    if phrase_enc == "lstm":
        _, ph = JaxLSTM(LSTM_H, compute_dtype=BF16).apply(
            {"params": params["phrase_lstm"]}, x, plen.reshape(-1))
    else:
        mask = (jnp.arange(L) < plen.reshape(-1)[:, None]).astype(x.dtype)
        ph = jnp.einsum("bld,bl->bd", x, mask) / jnp.maximum(
            plen.reshape(-1, 1).astype(x.dtype), 1.0)
    args = (ph.reshape(I, M, -1) @ params["head_dense_phrase"]["kernel"],
            jb["box_feats"] @ params["head_dense_box"]["kernel"],
            params["head_dense_phrase"]["bias"], params["head_out"]["kernel"],
            params["head_out"]["bias"])
    logits = _jax_fast_dot([np.asarray(a) for a in args])
    return (np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1)),
            np.asarray(jax_rank_boxes(jnp.asarray(logits), jb["box_valid"])))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("phrase_enc", ["lstm", "mean_w2v"])
def test_bf16_affinity_probs_and_rank_match_jax(phrase_enc, fused):
    from test_torch_affinity import (BOX_D, EMB_D, _jax_params, _table,
                                     affinity_batch)

    table, arrays = _table(), affinity_batch(seed=4)
    params = _jax_params(phrase_enc, table, arrays)
    jt = jnp.asarray(table)

    def jax_out(dtype, boxes_dtype):
        jb = {k: jnp.asarray(v) for k, v in arrays.items()}
        jb["box_feats"] = jb["box_feats"].astype(boxes_dtype)
        model = JaxAffinityModel(lstm_hidden=LSTM_H, head_hidden=HEAD_H,
                                 phrase_enc=phrase_enc, compute_dtype=dtype)
        logits = model.apply({"params": params}, jt.astype(dtype), jb,
                             deterministic=True)
        return (np.asarray(jax.nn.softmax(logits, axis=-1)),
                np.asarray(jax_rank_boxes(logits, jb["box_valid"])))

    want_f32 = jax_out(jnp.float32, jnp.float32)
    if fused:
        jb = {k: jnp.asarray(v) for k, v in arrays.items()}
        jb["box_feats"] = jb["box_feats"].astype(BF16)
        want = _jax_affinity_fused_bf16(phrase_enc, params, jt.astype(BF16),
                                        jb)
    else:
        want = jax_out(BF16, BF16)
    model = AffinityModel(EMB_D, BOX_D, LSTM_H, HEAD_H, phrase_enc=phrase_enc,
                          fused=fused, compute_dtype=torch.bfloat16)
    model.load_flat({k: torch.from_numpy(v.copy())
                     for k, v in flatten_params(params).items()})
    batch = _torch(with_box_dtype(arrays, torch.bfloat16))
    assert batch["box_feats"].dtype == torch.bfloat16
    probs, rank = steps.affinity_predict(
        model, torch.from_numpy(table).bfloat16(), batch, rank=True)
    _within_twice_jax(probs, want[0], want_f32[0], "affinity probs")
    _within_twice_jax(rank, want[1], want_f32[1], "affinity rank")


def test_with_box_dtype_rounds_to_nearest_even():
    """The host conversion of the box block: torch's float32 -> bf16 rounds
    to nearest even, as the reference's ml_dtypes does (jnp's astype stands
    in for it here), and leaves the other arrays alone."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 3, 40)).astype(np.float32)
    feats[0, 0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.0]
    arrays = {"box_feats": feats, "box_valid": np.ones((2, 3), bool)}
    got = with_box_dtype(arrays, torch.bfloat16)
    assert got["box_valid"] is arrays["box_valid"]
    want = np.asarray(jnp.asarray(feats).astype(BF16).astype(jnp.float32))
    assert np.array_equal(got["box_feats"].float().numpy(), want)
    assert with_box_dtype(arrays, torch.float32) is arrays
    assert with_box_dtype({"tokens": feats}, torch.bfloat16)["tokens"] is feats


def test_affinity_batcher_rounds_the_box_block_in_bf16(tmp_path):
    """With ``box_dtype=torch.bfloat16`` the batcher rounds the box block as
    it builds a batch (on the thread that builds it): its batches are the
    float32 batcher's with ``box_feats`` rounded by ``with_box_dtype``."""
    from icl_torch.data.embeddings import EmbeddingStore
    from icl_torch.data.imagebatch import AffinityBatcher
    from icl_torch.data.pipeline import load_affinity_dataset
    from icl_torch.testing.synth import SynthConfig, generate_dataset

    generate_dataset(str(tmp_path), "train", SynthConfig(num_images=6,
                                                         seed=2))
    ds = load_affinity_dataset(str(tmp_path), "train", EmbeddingStore.load(
        str(tmp_path / "embeddings.txt")))
    f32, bf16 = (list(AffinityBatcher(images_per_batch=4, box_dtype=dt)
                      .batches(ds)) for dt in (torch.float32, torch.bfloat16))
    assert len(f32) == len(bf16) > 0
    for a, b in zip(f32, bf16):
        assert a.id_index == b.id_index and sorted(a.arrays) == sorted(
            b.arrays)
        assert isinstance(a.arrays["box_feats"], np.ndarray)
        assert b.arrays["box_feats"].dtype == torch.bfloat16
        assert torch.equal(b.arrays["box_feats"], with_box_dtype(
            a.arrays, torch.bfloat16)["box_feats"])
        for k in set(a.arrays) - {"box_feats"}:
            assert np.array_equal(a.arrays[k], b.arrays[k]), k


# --- (e) one train step --------------------------------------------------------

def _jax_grads(model_cls, kw, dtype, params, table, jb, cw):
    """Loss and gradients of one JAX step at dropout 0 under 'highest'
    (the training head's exact dots), in ``dtype``."""
    model = model_cls(**kw, dropout=0.0, fused=True, compute_dtype=dtype)
    cwj = jnp.asarray(cw, jnp.float32)
    table = table.astype(dtype)

    def loss_fn(p):
        w = jax_steps._cell_weights(jb["grid_label"], jb["grid_valid"], cwj)
        sums = model.apply({"params": p}, table, jb, deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)},
                           loss_grid=(jb["grid_label"], w))
        return sums[0] / jnp.maximum(jnp.sum(w), 1.0)

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.value_and_grad(loss_fn)(params)
    return loss, flatten_params(grads)


def _port_grads(model, table, batch, cw, loss_fn):
    """Loss and gradients of the port's training pass (seeds given: the
    training kernels, here at dropout 0)."""
    model.zero_grad(set_to_none=True)
    seeds = torch.zeros(next(iter(batch.values())).shape[0],
                        dtype=torch.int32)
    loss, _ = loss_fn(model, table, batch, seeds,
                      torch.tensor(cw, dtype=torch.float32), grid_loss=True)
    loss.backward()
    return loss, {k.replace(".", "/"): p.grad
                  for k, p in model.named_parameters()}


def _check_step(port, want, want_f32):
    loss, grads = port
    _within_twice_jax(loss, want[0], want_f32[0], "loss")
    assert sorted(grads) == sorted(want[1])
    assert all(g.dtype == torch.float32 for g in grads.values())
    # the gradients of the step as a whole: one tensor's own distance is
    # too few rounding flips to measure a rule by; an LSTM weight's
    # gradient comes through a bf16 cast, so one bf16 unit of the largest
    # gradient is the resolution of the comparison
    err = max(float(np.abs(_np(g) - _np(want[1][k])).max())
              for k, g in grads.items())
    own = max(float(np.abs(_np(want[1][k]) - _np(want_f32[1][k])).max())
              for k in grads)
    top = max(float(np.abs(_np(w)).max()) for w in want[1].values())
    assert err <= 2 * own + _ulp(top), (err, own, top)


def test_bf16_relation_train_step_matches_jax(emb, synth_dir):
    arrays = _relation_batch(emb, synth_dir)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    table = jnp.asarray(emb.table)
    kw = dict(lstm_hidden=LSTM_H, head_hidden=HEAD_H)
    params = jax_create_train_state(JaxRelationModel(**kw), (table, jb),
                                    seed=0).params
    cw = [0.3, 1.0, 1.0, 1.0]
    want = _jax_grads(JaxRelationModel, kw, BF16, params, table, jb, cw)
    want_f32 = _jax_grads(JaxRelationModel, kw, jnp.float32, params, table,
                          jb, cw)
    model = RelationModel(emb.dim, LSTM_H, HEAD_H, fused=True, dropout=0.0,
                          compute_dtype=torch.bfloat16)
    model.load_flat({k: torch.from_numpy(np.array(v))
                     for k, v in flatten_params(params).items()})
    _check_step(_port_grads(model, torch.from_numpy(emb.table).bfloat16(),
                            _torch(arrays), cw, steps.relation_loss),
                want, want_f32)


def test_bf16_affinity_train_step_matches_jax():
    from test_torch_affinity import (BOX_D, EMB_D, _jax_params, _table,
                                     affinity_batch)

    table, arrays = _table(), affinity_batch(seed=2)
    params = _jax_params("lstm", table, arrays)
    kw = dict(lstm_hidden=LSTM_H, head_hidden=HEAD_H)
    cw = [0.5, 1.0]
    jt = jnp.asarray(table)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    want_f32 = _jax_grads(JaxAffinityModel, kw, jnp.float32, params, jt, jb,
                          cw)
    jb["box_feats"] = jb["box_feats"].astype(BF16)
    want = _jax_grads(JaxAffinityModel, kw, BF16, params, jt, jb, cw)
    model = AffinityModel(EMB_D, BOX_D, LSTM_H, HEAD_H, fused=True,
                          dropout=0.0, compute_dtype=torch.bfloat16)
    model.load_flat({k: torch.from_numpy(np.array(v))
                     for k, v in flatten_params(params).items()})
    _check_step(_port_grads(model, torch.from_numpy(table).bfloat16(),
                            _torch(with_box_dtype(arrays, torch.bfloat16)),
                            cw, steps.affinity_loss),
                want, want_f32)


# --- (f) the planted convergence gate ---------------------------------------

def test_planted_relation_in_bf16_lands_within_4_points_of_f32(tmp_path):
    """As tests/integration/test_convergence.py: the same planted split,
    widths, seed and budget as the f32 gate of tests/test_torch_loop.py,
    trained and predicted through the port's CLI in f32 and in bf16."""
    from icl.io.feats import read_feats
    from icl.io.scores import read_scores
    from icl.testing import SynthConfig, generate_dataset
    from icl_torch.cli import relation

    d = tmp_path / "planted"
    cfg = dict(captions_per_image=3, vocab_size=16, emb_dim=16,
               max_mentions_per_caption=2, max_boxes_per_image=4,
               planted=True)
    generate_dataset(str(d), "train", SynthConfig(num_images=96, seed=1,
                                                  **cfg))
    generate_dataset(str(d), "dev", SynthConfig(num_images=24, seed=1, **cfg))
    gold = {ex.example_id: int(ex.label)
            for ex in read_feats(str(d / "dev.relation.feats"))}
    acc = {}
    for dtype in ("f32", "bf16"):
        common = ["--data_dir", str(d), "--images_per_batch", "16",
                  "--device", "cpu", "--fused", "on", "--compute_dtype",
                  dtype, "--model_file", str(tmp_path / f"{dtype}.model")]
        relation.main(["--train", "--data_split", "train", "--epochs", "25",
                       "--lstm_hidden_width", "24", "--head_hidden", "48",
                       "--dropout", "0.0", "--seed", "3", "--learn_rate",
                       "0.01", *common])
        scores = tmp_path / f"{dtype}.scores"
        relation.main(["--predict", "--data_split", "dev", "--scores_file",
                       str(scores), *common])
        ids, probs = read_scores(str(scores))
        y = np.array([gold[i] for i in ids])
        assert len(y) > 90
        acc[dtype] = float((y == probs.argmax(axis=1)).mean())
    assert acc["f32"] >= 0.93 and acc["bf16"] >= 0.90, acc
    assert abs(acc["f32"] - acc["bf16"]) <= 0.04, acc
