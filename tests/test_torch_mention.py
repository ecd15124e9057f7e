"""icl_torch mention tasks (nonvisual, cardinality) vs the JAX package
(CPU, f32).

The same numpy inputs, made from a seed, go to both sides; weights cross
as numpy through the pinned keys (``dense_1/kernel`` ...).  The JAX side
runs under ``jax.default_matmul_precision("highest")``.  Gate: max |port -
jax| <= 1e-5 * max(1, max |jax|) unless said.  Dropout cannot be matched
bit for bit (flax draws from ``jax.random``), so the train step is held to
JAX at rate 0 and the port's mask to its own contract at 0.5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl.cli.export import flatten_params
from icl.cli.import_ import unflatten_params
from icl.dist.mesh import build_mesh
from icl.models.cardinality import CARDINALITY_CLASSES as JAX_CARD_CLASSES
from icl.models.cardinality import CardinalityModel as JaxCardinalityModel
from icl.models.nonvisual import NONVIS_CLASSES as JAX_NONVIS_CLASSES
from icl.models.nonvisual import NonvisualModel as JaxNonvisualModel
from icl.models.nonvisual import mean_pool_tokens as jax_mean_pool_tokens
from icl.train import evalhook as jax_evalhook
from icl.train import steps as jax_steps
from icl.train.state import create_train_state as jax_create_train_state
from icl_torch.models.cardinality import CARDINALITY_CLASSES, CardinalityModel
from icl_torch.models.nonvisual import (NONVIS_CLASSES, NonvisualModel,
                                       mean_pool_tokens, row_keep_mask)
from icl_torch.ops.grid_head_train import dropout_scale
from icl_torch.params import PARAM_SHAPES, init_params
from icl_torch.train import evalhook, steps
from icl_torch.train.state import create_train_state

GATE = 1e-5
D, HIDDEN, VOCAB, L = 16, 32, 40, 6
MODELS = {"nonvisual": (JaxNonvisualModel, NonvisualModel, 2),
          "cardinality": (JaxCardinalityModel, CardinalityModel, 12)}


@pytest.fixture(autouse=True, scope="module")
def _f32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, want, what="", gate=GATE):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = gate * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _table(seed=0):
    table = np.random.default_rng(seed).normal(
        size=(VOCAB, D)).astype(np.float32)
    table[0] = 0.0                                   # PAD / OOV row
    return table


def _batch(seed, n=24, num_classes=2, length=L):
    """Padded mention rows with OOV tokens (id 0) inside the true length, a
    length-0 row, full rows, and some batch-padding rows."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, length + 1, size=n).astype(np.int32)
    lengths[0], lengths[1] = 0, length
    tok = rng.integers(1, VOCAB, size=(n, length)).astype(np.int32)
    tok[rng.random((n, length)) < 0.2] = 0           # OOV: counts in the mean
    tok[np.arange(length) >= lengths[:, None]] = 0   # padding
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    valid = rng.random(n) < 0.8
    valid[:2] = True
    return tok, lengths, labels, valid


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _pair(task, seed=3, dropout=0.0, learn_rate=1e-3):
    """A JAX state and a port state of ``task`` holding the same weights
    (drawn by the port from ``seed``, crossing as numpy)."""
    jcls, tcls, C = MODELS[task]
    flat = {k: v.numpy() for k, v in init_params(
        task, seed, {"emb_dim": D, "hidden": HIDDEN}).items()}
    # biases are drawn zero; make them count
    rng = np.random.default_rng(seed)
    for k in flat:
        if k.endswith("bias"):
            flat[k] = (rng.normal(size=flat[k].shape) * 0.1).astype(np.float32)
    jmodel = jcls(hidden=HIDDEN, dropout=dropout, num_classes=C)
    jstate = jax_create_train_state(
        jmodel, (jnp.zeros((1, D), jnp.float32),), seed=seed,
        learn_rate=learn_rate)
    params = jax.tree.map(jnp.asarray, unflatten_params(flat))
    jstate = jstate.replace(params=params,
                            opt_state=jstate.tx.init(params))
    tmodel = tcls(emb_dim=D, hidden=HIDDEN, dropout=dropout)
    tstate = create_train_state(tmodel, seed=seed, learn_rate=learn_rate,
                                params=flat)
    return jmodel, jstate, tmodel, tstate


def test_class_orders_and_param_keys_match_jax():
    assert NONVIS_CLASSES == JAX_NONVIS_CLASSES
    assert CARDINALITY_CLASSES == JAX_CARD_CLASSES
    for task, (jcls, tcls, C) in MODELS.items():
        params = jcls(hidden=HIDDEN).init(
            jax.random.PRNGKey(0), jnp.zeros((1, D)))["params"]
        want = {k: v.shape for k, v in flatten_params(params).items()}
        dims = {"emb_dim": D, "hidden": HIDDEN}
        assert PARAM_SHAPES[task](dims) == want
        model = tcls(emb_dim=D, hidden=HIDDEN)
        assert {k: tuple(v.shape)
                for k, v in model.flat_params().items()} == want
        assert model.task == task and model.dims["num_classes"] == C


@pytest.mark.parametrize("case", ["ragged", "L=1", "all length 0"])
def test_mean_pool_tokens_matches_jax(case):
    table = _table()
    tok, lengths, _, _ = _batch(1, length=1 if case == "L=1" else L)
    if case == "all length 0":
        lengths[:] = 0
    want = jax_mean_pool_tokens(*_j(table, tok, lengths))
    got = mean_pool_tokens(*_t(table, tok, lengths))
    _close(_np(got), want, case)
    if case == "ragged":
        # an OOV token inside the length counts in the denominator
        row = np.array([[5, 0, 7, 0, 0, 0]], np.int32)
        got = mean_pool_tokens(*_t(table, row, np.array([3], np.int32)))
        _close(_np(got)[0], (table[5] + table[7]) / 3.0, "OOV denominator")
        assert not _np(mean_pool_tokens(
            *_t(table, row, np.array([0], np.int32)))).any()   # length 0


@pytest.mark.parametrize("task", sorted(MODELS))
def test_logits_and_predict_match_jax(task):
    jmodel, jstate, tmodel, _ = _pair(task)
    table = _table()
    tok, lengths, _, _ = _batch(2)
    pooled = np.asarray(jax_mean_pool_tokens(*_j(table, tok, lengths)))
    want = jmodel.apply({"params": jstate.params}, jnp.asarray(pooled),
                        deterministic=True)
    _close(_np(tmodel(torch.from_numpy(pooled.copy()))), want, "logits")
    want = jax_steps.make_mention_predict(jmodel.apply)(
        jstate.params, *_j(table, tok, lengths))
    got = steps.mention_predict(tmodel, *_t(table, tok, lengths))
    _close(_np(got), want, "probs")
    assert got.shape == (len(tok), MODELS[task][2])
    assert np.abs(_np(got).sum(-1) - 1).max() <= 1e-6
    _close(_np(tmodel.probs_from_tokens(*_t(table, tok, lengths))), want,
           "probs_from_tokens")


@pytest.mark.parametrize("task", sorted(MODELS))
def test_one_train_step_at_dropout_0_matches_jax(task):
    jmodel, jstate, tmodel, tstate = _pair(task)
    table = _table()
    C = MODELS[task][2]
    batches = [_batch(10 + i, num_classes=C) for i in range(5)]

    # the loss, the accuracy and the four gradients before the update
    def jax_loss(params, tok, ln, lab, valid):
        pooled = jax_mean_pool_tokens(jnp.asarray(table), tok, ln)
        logits = jmodel.apply({"params": params}, pooled, deterministic=True)
        return jax_steps.masked_weighted_ce(logits, lab, valid), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(
        jstate.params, *_j(*batches[0]))
    jstep = jax_steps.make_mention_train_step(donate=False)
    tstep = steps.make_mention_train_step()
    tt = torch.from_numpy(table)
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, jnp.asarray(table), *_j(*b))
        tm = tstep(tstate, tt, *_t(*b))
        gate = GATE if i == 0 else 1e-4
        _close(_np(tm["loss"]), jm["loss"], f"loss step {i + 1}", gate)
        _close(_np(tm["acc"]), jm["acc"], f"acc step {i + 1}", gate)
        if i == 0:
            _close(_np(tm["loss"]), jl, "loss")
            _close(_np(tm["acc"]), jax_steps._accuracy(
                jlogits, *_j(*b[2:])), "acc")
            want = flatten_params(jgrads)
            grads = {k.replace(".", "/"): p.grad
                     for k, p in tmodel.named_parameters()}
            assert sorted(grads) == sorted(want) and len(want) == 4
            for k, g in want.items():
                _close(_np(grads[k]), g, f"grad {k}")
        if i in (0, 4):                       # after 1 step, after 5 steps
            want = flatten_params(jstate.params)
            for k, v in tmodel.flat_params().items():
                _close(_np(v), want[k], f"param {k} after {i + 1}", gate)
    assert tstate.step == 5 == int(jstate.step)


def test_the_table_gets_no_gradient_and_is_not_in_the_state():
    _, _, tmodel, tstate = _pair("nonvisual")
    table = torch.from_numpy(_table()).requires_grad_()
    steps.make_mention_train_step()(tstate, table, *_t(*_batch(4)))
    assert table.grad is None
    assert sorted(tmodel.state_dict()) == [
        "dense_1.bias", "dense_1.kernel", "dense_out.bias",
        "dense_out.kernel"]
    held = sum(len(g["params"]) for g in tstate.optimizer.param_groups)
    assert held == 4                          # Adam sees the four tensors


def test_padded_rows_do_not_change_the_step():
    """Rows with valid=False contribute no loss and no gradient."""
    _, _, ma, sa = _pair("cardinality")
    _, _, mb, sb = _pair("cardinality")
    table = torch.from_numpy(_table())
    tok, ln, lab, valid = _batch(6, num_classes=12)
    step = steps.make_mention_train_step()
    a = step(sa, table, *_t(tok, ln, lab, valid))
    tok2, lab2 = tok.copy(), lab.copy()
    tok2[~valid] = 3
    lab2[~valid] = 11
    b = step(sb, table, *_t(tok2, ln, lab2, valid))
    assert torch.equal(a["loss"], b["loss"])
    for (k, p), (_, q) in zip(ma.named_parameters(), mb.named_parameters()):
        assert torch.equal(p, q), k


def test_dropout_mask_contract_at_rate_half():
    """The mask is a pure function of (run seed, step, row, hidden unit):
    per-row seeds from ``TrainState.dropout_seeds``, the port's hash."""
    rate, K, rows = 0.5, 300, 512
    _, _, model, state = _pair("nonvisual", dropout=rate)
    seeds = state.dropout_seeds(rows)
    assert seeds.shape == (rows,) and seeds.dtype == torch.int32
    keep = row_keep_mask(seeds, K, rate)
    assert keep.shape == (rows, K) and keep.dtype == torch.bool
    # a function of its arguments: the same again, and row by row (a
    # sharded batch reproduces the single-device masks)
    assert torch.equal(keep, row_keep_mask(state.dropout_seeds(rows), K, rate))
    assert torch.equal(keep[7:9], row_keep_mask(seeds[7:9], K, rate))
    assert torch.equal(keep[:, :64], row_keep_mask(seeds, 64, rate))
    # another step, another run seed: other masks
    state.step += 1
    assert not torch.equal(keep, row_keep_mask(state.dropout_seeds(rows),
                                               K, rate))
    state.step -= 1
    state.seed += 1
    assert not torch.equal(keep, row_keep_mask(state.dropout_seeds(rows),
                                               K, rate))
    state.seed -= 1
    # keep rate within 3 sigma of 1 - rate, over all and per unit on average
    n = rows * K
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(keep.float().mean().item() - (1 - rate)) <= 3 * sigma
    assert keep.any(dim=0).all() and not keep.all(dim=0).any()
    # rows differ from each other (per-row seeds, not one mask a batch)
    assert len({tuple(r) for r in keep[:32, :64].tolist()}) == 32

    # the model applies exactly this mask, kept units scaled by 1/(1-rate)
    rng = np.random.default_rng(0)
    pooled = torch.from_numpy(rng.normal(size=(rows, D)).astype(np.float32))
    wide = NonvisualModel(emb_dim=D, hidden=K, dropout=rate)
    wide.load_flat(init_params("nonvisual", 1, {"emb_dim": D, "hidden": K}))
    h = torch.relu(pooled @ wide.dense_1.kernel + wide.dense_1.bias)
    want = (h * keep * dropout_scale(rate)) @ wide.dense_out.kernel \
        + wide.dense_out.bias
    got = wide(pooled, seeds=seeds)
    _close(_np(got), _np(want), "logits under the mask", 1e-6)
    assert dropout_scale(rate) == 2.0
    assert not torch.equal(got, wide(pooled))        # predict: no dropout
    # rate 0 in training mode is the deterministic forward
    dry = NonvisualModel(emb_dim=D, hidden=K, dropout=0.0)
    dry.load_flat(wide.flat_params())
    assert torch.equal(dry(pooled, seeds=seeds), dry(pooled))


def test_the_train_step_draws_its_masks_from_seed_and_step():
    """Two runs with one seed take the same steps; another seed does not."""
    table = torch.from_numpy(_table())
    batches = [_t(*_batch(20 + i)) for i in range(3)]
    ends = []
    for seed in (3, 3, 4):
        _, _, model, state = _pair("nonvisual", dropout=0.5)
        state.seed = seed
        step = steps.make_mention_train_step()
        for b in batches:
            step(state, table, *b)
        ends.append(model.flat_params())
    assert all(torch.equal(ends[0][k], ends[1][k]) for k in ends[0])
    assert any(not torch.equal(ends[0][k], ends[2][k]) for k in ends[0])


@pytest.mark.parametrize("task", sorted(MODELS))
def test_mention_eval_fn_matches_jax_and_pin_is_bitwise(task):
    jmodel, jstate, tmodel, tstate = _pair(task)
    table = _table()
    C = MODELS[task][2]
    batches = [_batch(30 + i, num_classes=C) for i in range(3)]
    want = jax_evalhook.make_mention_eval_fn(
        jmodel, jnp.asarray(table), batches, build_mesh("1"))(jstate)
    tt = torch.from_numpy(table)
    pinned = evalhook.make_mention_eval_fn(tmodel, tt, batches)(tstate)
    copied = evalhook.make_mention_eval_fn(tmodel, tt, batches,
                                           pin=False)(tstate)
    assert pinned == copied                           # bitwise
    assert set(pinned) == {"loss", "acc"}
    _close(pinned["loss"], want["loss"], "eval loss")
    _close(pinned["acc"], want["acc"], "eval acc")
    # sums over the whole set, then one division: not a mean of batch means
    nval = sum(int(b[3].sum()) for b in batches)
    per_batch = [evalhook.make_mention_eval_fn(tmodel, tt, [b])(tstate)
                 for b in batches]
    total = sum(r["loss"] * int(b[3].sum())
                for r, b in zip(per_batch, batches)) / nval
    _close(pinned["loss"], total, "whole-set normaliser")
    assert tmodel.training                            # mode put back
