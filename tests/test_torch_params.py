"""icl_torch.params: the icl-export archive <-> torch tensors.

* a JAX RelationModel tree, flattened as ``icl-export`` flattens it, loads
  into the port and comes back byte-identical;
* an archive the port writes has the export format: sorted members, and a
  manifest whose shapes and dtypes match; JAX loads it and predicts what the
  port predicts;
* ``init_relation_params`` gives the pinned keys and shapes at full width,
  with the initializer families' properties.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _synth_relation_batch
from icl.cli.export import flatten_params
from icl.cli.import_ import unflatten_params
from icl.models import RelationModel as JaxRelationModel
from icl.train.steps import make_relation_predict
from icl_torch.models.relation import RelationModel
from icl_torch.params import (init_relation_params, load_npz,
                              relation_param_shapes, save_npz, to_numpy)
from icl_torch.train.steps import relation_predict

DIMS = {"emb_dim": 12, "lstm_hidden": 8, "head_hidden": 16}


def _batch(seed=0):
    b = _synth_relation_batch(np.random.default_rng(seed), I=2, C=3, L=8,
                              M=5, vocab=40)
    return {k: np.asarray(v) for k, v in b.items()}


def test_jax_tree_roundtrips_byte_identically(tmp_path):
    """flatten_params -> .npz + manifest, written as icl-export writes them
    (sorted members, per-leaf shape and dtype) -> the port -> numpy."""
    table = jnp.asarray(np.random.default_rng(1).normal(
        size=(40, DIMS["emb_dim"])).astype(np.float32))
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    params = JaxRelationModel(lstm_hidden=8, head_hidden=16).init(
        jax.random.PRNGKey(4), table, jb)["params"]
    want = dict(sorted(flatten_params(params).items()))
    out = str(tmp_path / "relation.npz")
    np.savez(out, **want)
    with open(out + ".manifest.json", "w") as f:
        json.dump({"step": 0, "params": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in want.items()}}, f)

    flat, manifest = load_npz(out)
    port = RelationModel(DIMS["emb_dim"], 8, 16)
    port.load_flat(flat)
    back = to_numpy(port.flat_params())
    assert sorted(back) == sorted(want) == sorted(manifest["params"])
    for k, v in want.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert back[k].tobytes() == v.tobytes(), k


def test_port_archive_has_export_format_and_loads_in_jax(tmp_path):
    flat = init_relation_params(3, DIMS)
    path = str(tmp_path / "relation.npz")
    manifest = save_npz(path, flat, {"task": "relation", **DIMS})
    assert manifest == json.load(open(path + ".manifest.json"))
    with np.load(path) as z:
        assert z.files == sorted(flat)
        for k in z.files:
            assert list(z[k].shape) == manifest["params"][k]["shape"]
            assert str(z[k].dtype) == manifest["params"][k]["dtype"]
            assert z[k].tobytes() == flat[k].numpy().tobytes()
        params = unflatten_params({k: z[k] for k in z.files})
    assert manifest["total_parameters"] == sum(
        v.numel() for v in flat.values())

    table = np.random.default_rng(2).normal(size=(40, 12)).astype(np.float32)
    batch = _batch(1)
    want = np.asarray(make_relation_predict(
        JaxRelationModel(lstm_hidden=8, head_hidden=16).apply)(
        params, jnp.asarray(table),
        {k: jnp.asarray(v) for k, v in batch.items()}))
    loaded, _ = load_npz(path)
    port = RelationModel(12, 8, 16)
    port.load_flat(loaded)
    got = relation_predict(port, torch.from_numpy(table),
                           {k: torch.from_numpy(v.copy())
                            for k, v in batch.items()}).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_load_rejects_manifest_mismatch(tmp_path):
    path = str(tmp_path / "relation.npz")
    save_npz(path, init_relation_params(0, DIMS))
    man = json.load(open(path + ".manifest.json"))
    man["params"]["head_out/bias"]["shape"] = [5]
    json.dump(man, open(path + ".manifest.json", "w"))
    with pytest.raises(ValueError, match="head_out/bias"):
        load_npz(path)


def test_init_relation_params_full_width():
    dims = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 800}
    flat = init_relation_params(0, dims)
    # the pinned keys and shapes are those of the JAX model's tree
    table = jax.ShapeDtypeStruct((50, 300), jnp.float32)
    jb = jax.tree.map(lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype),
                      _batch())
    shapes = jax.eval_shape(JaxRelationModel().init, jax.random.PRNGKey(0),
                            table, jb)["params"]
    want = {"/".join(p.key for p in path): leaf.shape for path, leaf
            in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    assert relation_param_shapes(dims) == want
    assert all(v.dtype == torch.float32 for v in flat.values())

    H = 200
    for d in ("fwd", "bwd"):
        bias = flat[f"caption_bilstm/{d}/bias"]
        assert torch.equal(bias[H:2 * H], torch.ones(H))          # forget
        assert not bias[:H].any() and not bias[2 * H:].any()
        R = flat[f"caption_bilstm/{d}/recurrent_kernel"].double()
        torch.testing.assert_close(R @ R.T, torch.eye(H).double(),
                                   rtol=0, atol=1e-5)             # orthogonal
        k = flat[f"caption_bilstm/{d}/kernel"]
        assert k.abs().max() <= np.sqrt(6 / (300 + 800))          # glorot
    W1 = flat["head_dense/kernel"]
    assert W1.abs().max() <= 2 * np.sqrt(1 / 1600) / 0.8796256610342398
    assert abs(W1.std().item() - np.sqrt(1 / 1600)) < 1e-3        # lecun
    assert not flat["head_dense/bias"].any()
    # the seed decides the draw
    again = init_relation_params(0, dims)
    assert all(torch.equal(flat[k], again[k]) for k in flat)


# --- the mention tasks' weights ---------------------------------------------

MENTION_TASKS = {"nonvisual": 2, "cardinality": 12}


@pytest.mark.parametrize("task", sorted(MENTION_TASKS))
def test_mention_params_full_width_and_round_trip(task, tmp_path):
    """The pinned keys and shapes are those of the JAX model's tree; Dense
    kernels lecun-normal, biases zero; a JAX tree goes through the archive
    into the port's model and comes back byte-identical."""
    from icl.models import CardinalityModel as JaxCardinalityModel
    from icl.models import NonvisualModel as JaxNonvisualModel
    from icl_torch.models import CardinalityModel, NonvisualModel
    from icl_torch.params import PARAM_SHAPES, init_params

    jcls, tcls = {"nonvisual": (JaxNonvisualModel, NonvisualModel),
                  "cardinality": (JaxCardinalityModel, CardinalityModel)}[task]
    C = MENTION_TASKS[task]
    dims = {"emb_dim": 300, "hidden": 300}
    params = jcls().init(jax.random.PRNGKey(2), jnp.zeros((1, 300)))["params"]
    want = dict(sorted(flatten_params(params).items()))
    shapes = {k: v.shape for k, v in want.items()}
    assert shapes == {"dense_1/kernel": (300, 300), "dense_1/bias": (300,),
                      "dense_out/kernel": (300, C), "dense_out/bias": (C,)}
    assert PARAM_SHAPES[task](dims) == shapes
    assert PARAM_SHAPES[task]({**dims, "num_classes": 5})[
        "dense_out/bias"] == (5,)

    flat = init_params(task, 0, dims)
    assert {k: tuple(v.shape) for k, v in flat.items()} == shapes
    assert all(v.dtype == torch.float32 for v in flat.values())
    W1 = flat["dense_1/kernel"]
    assert W1.abs().max() <= 2 * np.sqrt(1 / 300) / 0.8796256610342398
    assert abs(W1.std().item() - np.sqrt(1 / 300)) < 2e-3         # lecun
    assert not flat["dense_1/bias"].any() and not flat["dense_out/bias"].any()
    again = init_params(task, 0, dims)
    assert all(torch.equal(flat[k], again[k]) for k in flat)
    other = init_params(task, 1, dims)
    assert not torch.equal(flat["dense_1/kernel"], other["dense_1/kernel"])

    out = str(tmp_path / f"{task}.npz")
    manifest = save_npz(out, {k: torch.from_numpy(v.copy())
                              for k, v in want.items()},
                        {"task": task, "hidden": 300}, step=3,
                        train_config={"learn_rate": 0.001})
    assert manifest["train_config"] == {"learn_rate": 0.001}
    assert manifest["step"] == 3 and manifest["total_parameters"] == sum(
        v.size for v in want.values())
    loaded, _ = load_npz(out)
    port = tcls(emb_dim=300)
    port.load_flat(loaded)
    back = to_numpy(port.flat_params())
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()
    with pytest.raises(RuntimeError):                 # another task's head
        tcls(emb_dim=300, num_classes=C + 1).load_flat(loaded)
