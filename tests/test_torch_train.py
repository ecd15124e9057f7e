"""icl_torch relation training vs the JAX package (CPU, f32).

The same numpy inputs go to both sides.  The JAX side runs under
``jax.default_matmul_precision("highest")``, which makes its training grid
head take f32-exact dots (``exact=True``, icl/models/relation.py); its
Pallas kernels run in interpret mode at dropout rate 0, as
tests/unit/test_grid_head_train.py runs them.  On the CPU the port's
kernel wrappers run their plain versions (forward) and explicit backward
formulas.  Gate: max |port - jax| <= 1e-5 * max(1, max |jax|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl.cli.export import flatten_params
from icl.data.imagebatch import RelationBatcher
from icl.data.pipeline import load_relation_dataset
from icl.models import RelationModel as JaxRelationModel
from icl.models.rnn import BiLSTM as JaxBiLSTM
from icl.ops import ce as jax_ce
from icl.ops import grid_head_train as jax_ght
from icl.train import steps as jax_steps
from icl.train.state import create_train_state as jax_create_train_state
from icl_torch.models.relation import RelationModel
from icl_torch.models.rnn import BiLSTM
from icl_torch.ops import ce, grid_head_train as ght
from icl_torch.train import steps
from icl_torch.train.state import create_train_state

GATE = 1e-5
LSTM_H, HEAD_H = 8, 16


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    tol = GATE * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_ce_weights_and_accuracy_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(5, 7, 4)).astype(np.float32) * 3
    logits[0, 0] = [1.0, 2.0, 2.0, -1.0]            # a tie: first max wins
    labels = rng.integers(-1, 6, size=(5, 7)).astype(np.int32)  # -1, 4, 5 too
    valid = rng.random((5, 7)) < 0.7
    cw4 = np.array([0.3, 1.0, 1.0, 1.0], np.float32)
    cw6 = np.array([0.3, 1.0, 2.5, 0.7, 1.9, 0.0], np.float32)
    jl, jy, jv = jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(valid)
    tl, ty, tv = (torch.from_numpy(logits), torch.from_numpy(labels),
                  torch.from_numpy(valid))

    ce_j, onehot_j = jax_ce.onehot_ce(jl, jy)
    ce_t, onehot_t = ce.onehot_ce(tl, ty)
    _close(_np(ce_t), ce_j, "onehot_ce")
    np.testing.assert_array_equal(_np(onehot_t), np.asarray(onehot_j))
    for cw in (None, cw4):
        _close(_np(steps.masked_weighted_ce(
                   tl, ty, tv, None if cw is None else torch.from_numpy(cw))),
               jax_steps.masked_weighted_ce(
                   jl, jy, jv, None if cw is None else jnp.asarray(cw)),
               f"masked_weighted_ce cw={cw}")
    _close(_np(steps._accuracy(tl, ty, tv)), jax_steps._accuracy(jl, jy, jv),
           "_accuracy")
    for cw in (None, cw6):
        np.testing.assert_array_equal(
            _np(steps._cell_weights(ty, tv, None if cw is None
                                    else torch.from_numpy(cw))),
            np.asarray(jax_steps._cell_weights(
                jy, jv, None if cw is None else jnp.asarray(cw))))


def _head_problem(G, A, B, K, O=4, seed=7):
    rng = np.random.default_rng(seed)
    f = np.float32
    X = (rng.normal(size=(G, A, K)) * 0.3).astype(f)
    Y = (rng.normal(size=(G, B, K)) * 0.3).astype(f)
    b1 = (rng.normal(size=(K,)) * 0.1).astype(f)
    W2 = (rng.normal(size=(K, O)) * 0.3).astype(f)
    b2 = (rng.normal(size=(O,)) * 0.1).astype(f)
    seeds = rng.integers(0, 2 ** 31 - 1, size=(G,)).astype(np.int32)
    labels = rng.integers(0, O, size=(G, A, B)).astype(np.int32)
    weights = ((rng.random((G, A, B)) > 0.25)
               * rng.choice([0.3, 1.0], size=(G, A, B))).astype(f)
    R = rng.normal(size=(G, A, B, O)).astype(f)
    return (X, Y, b1, W2, b2), seeds, labels, weights, R


# one tile per image on the JAX side (its flat kernels), and a shape it
# tiles (Ta=16, Tb=32: its general kernels)
HEAD_SHAPES = [(3, 10, 13, 48), (2, 24, 40, 32)]


@pytest.mark.parametrize("G,A,B,K", HEAD_SHAPES)
def test_grid_head_train_loss_matches_jax(G, A, B, K):
    params, seeds, labels, weights, _ = _head_problem(G, A, B, K)
    wsum = float(weights.sum())

    def jax_loss(*p):
        out = jax_ght.grid_head_train_loss(
            *p, jnp.asarray(seeds), jnp.asarray(labels), jnp.asarray(weights),
            0.0, True)
        return out[0] / wsum, out

    (_, want), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *map(jnp.asarray, params))
    tp = [torch.from_numpy(p).requires_grad_() for p in params]
    got = ght.grid_head_train_loss(
        *tp, torch.from_numpy(seeds), torch.from_numpy(labels),
        torch.from_numpy(weights), 0.0)
    (got[0] / wsum).backward()
    for name, g, w in zip(("loss_sum", "hits", "nvalid"), got, want):
        _close(_np(g), w, name)
    for name, t, jg in zip(("dX", "dY", "db1", "dW2", "db2"), tp, jgrads):
        _close(_np(t.grad), jg, name)


@pytest.mark.parametrize("G,A,B,K", HEAD_SHAPES)
def test_grid_head_train_matches_jax(G, A, B, K):
    params, seeds, _, _, R = _head_problem(G, A, B, K, seed=9)

    def jax_obj(*p):
        out = jax_ght.grid_head_train(*p, jnp.asarray(seeds), 0.0, True)
        return jnp.sum(out * jnp.asarray(R)), out

    (_, want), jgrads = jax.value_and_grad(
        jax_obj, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *map(jnp.asarray, params))
    tp = [torch.from_numpy(p).requires_grad_() for p in params]
    out = ght.grid_head_train(*tp, torch.from_numpy(seeds), 0.0)
    (out * torch.from_numpy(R)).sum().backward()
    _close(_np(out), want, "logits")
    for name, t, jg in zip(("dX", "dY", "db1", "dW2", "db2"), tp, jgrads):
        _close(_np(t.grad), jg, name)


# shapes that stress the CUDA forward kernels' tiling (4 x 4 and 2 x 2
# register tiles of cells, 16-byte chunks of K): ragged A and B, K no
# multiple of 4, every head width
TILE_EDGE_SHAPES = [(1, 5, 7, 30, 1), (2, 7, 9, 50, 2), (2, 9, 17, 30, 3),
                    (1, 17, 20, 50, 4), (2, 20, 33, 30, 8)]


def _jax_loss_and_grads(params, seeds, labels, weights, div):
    def jax_loss(*p):
        out = jax_ght.grid_head_train_loss(
            *p, jnp.asarray(seeds), jnp.asarray(labels), jnp.asarray(weights),
            0.0, True)
        return out[0] / div, out

    (_, sums), grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *map(jnp.asarray, params))
    return sums, grads


def _torch_loss_and_grads(params, seeds, labels, weights, div):
    tp = [torch.from_numpy(p).requires_grad_() for p in params]
    sums = ght.grid_head_train_loss(
        *tp, torch.from_numpy(seeds), torch.from_numpy(labels),
        torch.from_numpy(weights), 0.0)
    (sums[0] / div).backward()
    return sums, [t.grad for t in tp]


@pytest.mark.parametrize("G,A,B,K,O", TILE_EDGE_SHAPES)
def test_grid_head_train_loss_matches_jax_at_tile_edges(G, A, B, K, O):
    params, seeds, labels, weights, _ = _head_problem(G, A, B, K, O, seed=11)
    div = max(float(weights.sum()), 1.0)
    want, jgrads = _jax_loss_and_grads(params, seeds, labels, weights, div)
    got, grads = _torch_loss_and_grads(params, seeds, labels, weights, div)
    for name, g, w in zip(("loss_sum", "hits", "nvalid"), got, want):
        _close(_np(g), w, name)
    for name, g, jg in zip(("dX", "dY", "db1", "dW2", "db2"), grads, jgrads):
        _close(_np(g), jg, name)


@pytest.mark.parametrize("G,A,B,K,O", TILE_EDGE_SHAPES)
def test_grid_head_train_matches_jax_at_tile_edges(G, A, B, K, O):
    params, seeds, _, _, R = _head_problem(G, A, B, K, O, seed=13)

    def jax_obj(*p):
        out = jax_ght.grid_head_train(*p, jnp.asarray(seeds), 0.0, True)
        return jnp.sum(out * jnp.asarray(R)), out

    (_, want), jgrads = jax.value_and_grad(
        jax_obj, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *map(jnp.asarray, params))
    tp = [torch.from_numpy(p).requires_grad_() for p in params]
    out = ght.grid_head_train(*tp, torch.from_numpy(seeds), 0.0)
    (out * torch.from_numpy(R)).sum().backward()
    _close(_np(out), want, "logits")
    for name, t, jg in zip(("dX", "dY", "db1", "dW2", "db2"), tp, jgrads):
        _close(_np(t.grad), jg, name)


@pytest.mark.parametrize("density", [0.0, 0.19, 1.0])
@pytest.mark.parametrize("G,A,B,K,O", [(3, 16, 16, 48, 4), (2, 9, 20, 30, 2)])
def test_grid_head_train_loss_matches_jax_at_weight_density(G, A, B, K, O,
                                                            density):
    """The CUDA kernels K7 and K8 skip cells of weight 0; the contract they
    keep: sums and gradients as the JAX kernels give them at every density,
    and all zero when no cell has weight."""
    params, seeds, labels, _, _ = _head_problem(G, A, B, K, O, seed=17)
    rng = np.random.default_rng(19)
    weights = ((rng.random((G, A, B)) < density)
               * rng.choice([0.3, 1.0], size=(G, A, B))).astype(np.float32)
    assert abs((weights > 0).mean() - density) < 0.06
    div = max(float(weights.sum()), 1.0)
    want, jgrads = _jax_loss_and_grads(params, seeds, labels, weights, div)
    got, grads = _torch_loss_and_grads(params, seeds, labels, weights, div)
    for name, g, w in zip(("loss_sum", "hits", "nvalid"), got, want):
        _close(_np(g), w, name)
    for name, g, jg in zip(("dX", "dY", "db1", "dW2", "db2"), grads, jgrads):
        _close(_np(g), jg, name)
    if density == 0.0:
        assert not any(_np(g).any() for g in got)
        assert not any(_np(g).any() for g in grads)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("L", [16, 32, 48])
def test_bilstm_grads_match_jax(L, use_kernel):
    """seq, final and the gradients of x and of every parameter; ragged
    lengths with a length-0 row.  ``use_kernel`` takes the port's
    autograd.Function (residuals + reverse loop); otherwise autograd
    differentiates the plain recurrence step by step."""
    B, D, H = 6, 12, LSTM_H
    rng = np.random.default_rng(L)
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    lengths = np.array([L, 0, 1, L // 2, L - 1, 3], np.int32)
    w_seq = rng.normal(size=(B, L, 2 * H)).astype(np.float32)
    w_fin = rng.normal(size=(B, 2 * H)).astype(np.float32)
    m = JaxBiLSTM(hidden=H)
    params = m.init(jax.random.PRNGKey(L), jnp.asarray(x),
                    jnp.asarray(lengths))["params"]

    def jax_obj(params, x):
        seq, fin = m.apply({"params": params}, x, jnp.asarray(lengths))
        return (jnp.sum(seq * jnp.asarray(w_seq))
                + jnp.sum(fin * jnp.asarray(w_fin))), (seq, fin)

    (_, (seq_j, fin_j)), (gp, gx) = jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    port = BiLSTM(D, H, use_kernel=use_kernel)
    port.load_state_dict({
        ".".join(p.key for p in path): torch.from_numpy(np.array(leaf))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]})
    tx = torch.from_numpy(x).requires_grad_()
    seq, fin = port(tx, torch.from_numpy(lengths))
    ((seq * torch.from_numpy(w_seq)).sum()
     + (fin * torch.from_numpy(w_fin)).sum()).backward()
    _close(_np(seq), seq_j, "seq")
    _close(_np(fin), fin_j, "final")
    assert not seq.detach()[1].any()                # the length-0 row
    _close(_np(tx.grad), gx, "dx")
    for d in ("fwd", "bwd"):
        for leaf in ("kernel", "recurrent_kernel", "bias"):
            _close(_np(getattr(getattr(port, d), leaf).grad), gp[d][leaf],
                   f"d{d}/{leaf}")


# --- one whole train step --------------------------------------------------

FORMS = {
    # name: (fused, grid_loss, class weights)
    "grid": (True, True, [0.3, 1.0, 1.0, 1.0]),
    "pair_null0": (True, True, [0.0, 1.0, 1.0, 1.0]),   # guard -> pair form
    "gather": (False, False, [0.3, 1.0, 1.0, 1.0]),
}


def _jax_step(fused, grid_loss, cw, table, jb):
    """JAX state, its step's new state, metrics and gradients."""
    model = JaxRelationModel(lstm_hidden=LSTM_H, head_hidden=HEAD_H,
                             dropout=0.0, fused=fused)
    st = jax_create_train_state(model, (table, jb), seed=0)
    step = jax_steps.make_relation_train_step(class_weights=cw, donate=False,
                                              grid_loss=grid_loss)
    new, metrics = step(st, table, jb)
    cwj = jnp.asarray(cw, jnp.float32)
    drng = st.step_rng()
    use_grid = grid_loss and min(cw) > 0

    def loss_fn(params):
        kw = dict(deterministic=False, rngs={"dropout": drng})
        if use_grid:
            w = jax_steps._cell_weights(jb["grid_label"], jb["grid_valid"],
                                        cwj)
            out = model.apply({"params": params}, table, jb,
                              loss_grid=(jb["grid_label"], w), **kw)
            return out[0] / jnp.maximum(jnp.sum(w), 1.0)
        logits = model.apply({"params": params}, table, jb, **kw)
        return jax_steps.masked_weighted_ce(logits, jb["pair_label"],
                                            jb["pair_valid"], cwj)

    grads = jax.grad(loss_fn)(st.params)
    return st, new, metrics, grads


@pytest.mark.parametrize("form", sorted(FORMS))
def test_train_step_matches_jax(emb, synth_dir, form):
    fused, grid_loss, cw = FORMS[form]
    ds = load_relation_dataset(synth_dir, "train", emb)
    arrays = next(iter(RelationBatcher(images_per_batch=4,
                                       build_grid=True).batches(ds))).arrays
    table = jnp.asarray(emb.table)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    with jax.default_matmul_precision("highest"):
        st, new, jm, jgrads = _jax_step(fused, grid_loss, cw, table, jb)

    model = RelationModel(emb.dim, LSTM_H, HEAD_H, fused=fused, dropout=0.0)
    state = create_train_state(model, params={
        k: v.copy() for k, v in flatten_params(st.params).items()})
    step = steps.make_relation_train_step(class_weights=cw,
                                          grid_loss=grid_loss)
    assert step.grid_loss == (form == "grid")
    tm = step(state, torch.from_numpy(emb.table),
              {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})
    assert state.step == 1
    _close(_np(tm["loss"]), jm["loss"], "loss")
    _close(_np(tm["acc"]), jm["acc"], "acc")
    grads = {k.replace(".", "/"): p.grad for k, p in
             model.named_parameters()}
    want_grads = flatten_params(jgrads)
    want_params = flatten_params(new.params)
    assert sorted(grads) == sorted(want_grads) == sorted(want_params)
    for k in sorted(grads):
        _close(_np(grads[k]), want_grads[k], f"grad {k}")
    for k, v in model.flat_params().items():
        _close(_np(v), want_params[k], f"new param {k}")


def test_class_weight_tensor_is_built_once_a_device(monkeypatch):
    """The train step keeps its class weights as one tensor per device
    instead of copying them from the host every step."""
    step = steps.make_relation_train_step(class_weights=[0.3, 1.0, 1.0, 1.0],
                                          grid_loss=True)
    made = []
    real = torch.as_tensor

    def counting(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(steps.torch, "as_tensor", counting)
    cpu = torch.device("cpu")
    first = step.class_weight_tensor(cpu)
    assert step.class_weight_tensor(cpu) is first and len(made) == 1
    assert first.dtype == torch.float32
    assert first.tolist() == pytest.approx([0.3, 1.0, 1.0, 1.0])
    assert step.class_weight_tensor(torch.device("meta")) is not first
    assert len(made) == 2
    assert steps.make_affinity_train_step().class_weight_tensor(cpu) is None
