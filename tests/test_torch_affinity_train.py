"""icl_torch affinity training vs the JAX package (CPU, f32).

One train step at dropout 0 against JAX ``make_affinity_train_step`` from
the same params: loss, acc, every gradient and the new params after Adam.
The JAX side runs under ``jax.default_matmul_precision("highest")`` (its
training grid head then takes f32-exact dots; its Pallas kernels run in
interpret mode at rate 0, as tests/unit/test_grid_head_train.py runs them).
At rate 0.5 the port's fused and plain forms share one hash mask and give
one loss.  Gate: max |port - jax| <= 1e-5 * max(1, max |jax|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl.cli.export import flatten_params
from icl.train import steps as jax_steps
from icl.train.state import create_train_state as jax_create_train_state
from icl_torch.models.affinity import AffinityModel
from icl_torch.train import steps
from icl_torch.train.state import create_train_state

from test_torch_affinity import (BOX_D, EMB_D, HEAD_H, LSTM_H, _close,
                                 _jax_model, _table, _torch, affinity_batch,
                                 batcher_batch)

FORMS = {
    # name: (fused, grid_loss, class weights, the step's form)
    "grid": (True, True, [0.4, 1.0], True),
    "grid_unweighted": (True, True, None, True),
    "cell_w0": (True, True, [0.0, 1.0], False),      # guard -> cell form
    "cell_plain": (False, False, [0.4, 1.0], False),
}


def _jax_step(phrase_enc, fused, grid_loss, cw, table, jb):
    """JAX state, its step's new state, metrics and gradients."""
    model = _jax_model(phrase_enc, dropout=0.0, fused=fused)
    st = jax_create_train_state(model, (table, jb), seed=0)
    step = jax_steps.make_affinity_train_step(class_weights=cw, donate=False,
                                              grid_loss=grid_loss)
    new, metrics = step(st, table, jb)
    cwj = None if cw is None else jnp.asarray(cw, jnp.float32)
    drng = st.step_rng()
    use_grid = grid_loss and (cw is None or min(cw) > 0)

    def loss_fn(params):
        kw = dict(deterministic=False, rngs={"dropout": drng})
        if use_grid:
            w = jax_steps._cell_weights(jb["grid_label"], jb["grid_valid"],
                                        cwj)
            out = model.apply({"params": params}, table, jb,
                              loss_grid=(jb["grid_label"], w), **kw)
            return out[0] / jnp.maximum(jnp.sum(w), 1.0)
        logits = model.apply({"params": params}, table, jb, **kw)
        return jax_steps.masked_weighted_ce(logits, jb["grid_label"],
                                            jb["grid_valid"], cwj)

    grads = jax.grad(loss_fn)(st.params)
    return new, metrics, grads, flatten_params(st.params)


@pytest.mark.parametrize("phrase_enc,form,source", [
    ("lstm", "grid", "synth"), ("lstm", "grid", "batcher"),
    ("lstm", "grid_unweighted", "synth"), ("lstm", "cell_w0", "synth"),
    ("lstm", "cell_plain", "synth"), ("mean_w2v", "grid", "synth"),
    ("mean_w2v", "cell_plain", "synth")])
def test_train_step_matches_jax(tmp_path, phrase_enc, form, source):
    fused, grid_loss, cw, step_form = FORMS[form]
    if source == "synth":
        table_np, arrays = _table(), affinity_batch(seed=6)
    else:
        table_np, arrays = batcher_batch(tmp_path)
    table = jnp.asarray(table_np)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    with jax.default_matmul_precision("highest"):
        new, jm, jgrads, p0 = _jax_step(phrase_enc, fused, grid_loss, cw,
                                        table, jb)

    model = AffinityModel(table_np.shape[1], arrays["box_feats"].shape[-1],
                          LSTM_H, HEAD_H, phrase_enc=phrase_enc, fused=fused,
                          dropout=0.0)
    state = create_train_state(model, params={k: v.copy()
                                              for k, v in p0.items()})
    step = steps.make_affinity_train_step(class_weights=cw,
                                          grid_loss=grid_loss)
    assert step.grid_loss == step_form
    tm = step(state, torch.from_numpy(table_np), _torch(arrays))
    assert state.step == 1
    _close(tm["loss"].numpy(), jm["loss"], "loss")
    _close(tm["acc"].numpy(), jm["acc"], "acc")
    grads = {k.replace(".", "/"): p.grad for k, p in model.named_parameters()}
    want_grads = flatten_params(jgrads)
    want_params = flatten_params(new.params)
    assert sorted(grads) == sorted(want_grads) == sorted(want_params)
    for k in sorted(grads):
        _close(grads[k].numpy(), want_grads[k], f"grad {k}")
    for k, v in model.flat_params().items():
        _close(v.numpy(), want_params[k], f"new param {k}")


@pytest.mark.parametrize("grid_loss", [True, False])
def test_fused_and_plain_forms_give_one_loss_at_rate_half(grid_loss):
    """Dropout 0.5: the fused form (K5/K6 or K7/K8 through their plain
    versions on the CPU) and the plain form (the materialised grid) apply
    one hash mask, so loss, metrics and every gradient agree."""
    table, arrays = _table(), affinity_batch(seed=8)
    dims = {"emb_dim": EMB_D, "box_dim": BOX_D, "lstm_hidden": LSTM_H,
            "head_hidden": HEAD_H}
    seeds = torch.tensor([11, 12, 13, 14], dtype=torch.int32)
    cw = torch.tensor([0.4, 1.0])
    out = {}
    for fused in (True, False):
        model = AffinityModel(**dims, fused=fused, dropout=0.5)
        create_train_state(model, seed=3)
        loss, metrics = steps.affinity_loss(model, torch.from_numpy(table),
                                            _torch(arrays), seeds, cw,
                                            grid_loss)
        loss.backward()
        out[fused] = metrics, {k: p.grad for k, p in model.named_parameters()}
    assert out[True][0]["loss"].item() > 0
    for k, v in out[False][0].items():
        _close(out[True][0][k].detach().numpy(), v.detach().numpy(), k)
    for k, g in out[False][1].items():
        _close(out[True][1][k].numpy(), g.numpy(), f"grad {k}")
    # the mask is on: the same model without dropout gives another loss
    model = AffinityModel(**dims, fused=True, dropout=0.0)
    create_train_state(model, seed=3)
    loss0, _ = steps.affinity_loss(model, torch.from_numpy(table),
                                   _torch(arrays), seeds, cw, grid_loss)
    assert abs(loss0.item() - out[True][0]["loss"].item()) > 1e-4


def test_create_train_state_initialises_either_model():
    dims = {"emb_dim": EMB_D, "box_dim": BOX_D, "lstm_hidden": LSTM_H,
            "head_hidden": HEAD_H}
    for enc in ("lstm", "mean_w2v"):
        model = AffinityModel(**dims, phrase_enc=enc)
        state = create_train_state(model, seed=2)
        flat = model.flat_params()
        assert flat["head_dense_box/kernel"].std() > 0
        assert ("phrase_lstm/kernel" in flat) == (enc == "lstm")
        assert state.dropout_seeds(4).shape == (4,)
