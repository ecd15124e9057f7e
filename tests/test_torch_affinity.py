"""icl_torch affinity weights, predict and box ranking vs the JAX package
(CPU, f32).

Small widths: LSTM 8, head 16, 12-d boxes, 10-d word vectors.  The same
numpy inputs go to both sides.  The JAX box-ranking kernel runs in
interpret mode, as tests/unit/test_affinity_rank.py runs it; on the CPU the
port's kernel wrappers run their plain versions.  Gate: max |port - jax|
<= 1e-5 * max(1, max |jax|), unless a test says otherwise.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl.cli.export import flatten_params
from icl.models import AffinityModel as JaxAffinityModel
from icl.models.affinity import rank_boxes as jax_rank_boxes
from icl.train.steps import make_affinity_predict
from icl_torch.models.affinity import AffinityModel, rank_boxes
from icl_torch.ops.affinity_rank import affinity_rank, affinity_rank_reference
from icl_torch.params import (affinity_param_shapes, init_params, load_npz,
                              save_npz, to_numpy)
from icl_torch.train.steps import affinity_predict

GATE = 1e-5
LSTM_H, HEAD_H, BOX_D, EMB_D, VOCAB = 8, 16, 12, 10, 30
ENCODERS = ("lstm", "mean_w2v")


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if not want.size:
        return
    tol = GATE * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def affinity_batch(seed=0, I=4, M=5, B=6, L=7, D=BOX_D, vocab=VOCAB):
    """A padded affinity batch as the batcher lays it out: ragged phrase
    lengths with length-0 phrases, invalid boxes, an image whose boxes are
    all invalid (image 2) and a padded image slot (the last)."""
    rng = np.random.default_rng(seed)
    plen = rng.integers(0, L + 1, size=(I, M)).astype(np.int32)
    plen[0, 1] = 0
    plen[0, 2] = L
    toks = rng.integers(1, vocab, size=(I, M, L)).astype(np.int32)
    toks[np.arange(L)[None, None, :] >= plen[..., None]] = 0
    nbox = np.array([B, 3, 0, 1][:I] + [B] * max(0, I - 4))
    box_valid = np.arange(B)[None, :] < nbox[:, None]
    feats = (rng.normal(size=(I, B, D)) * box_valid[..., None]).astype(
        np.float32)
    plen[-1], toks[-1], box_valid[-1], feats[-1] = 0, 0, False, 0.0
    mention_valid = np.arange(M)[None, :] < np.array([M, 4, 3, 0][:I])[:, None]
    return {"phrase_tokens": toks, "phrase_len": plen, "box_feats": feats,
            "box_valid": box_valid,
            "grid_label": rng.integers(0, 2, size=(I, M, B)).astype(np.int32),
            "grid_valid": mention_valid[:, :, None] & box_valid[:, None, :],
            "img_valid": np.array([True] * (I - 1) + [False])}


def batcher_batch(tmp_path, seed=3):
    """The first AffinityBatcher batch (4 images a batch, phrase_len 16) of
    a synthetic split written with 10-d word vectors and its boxes
    rewritten at 12-d, as the card phases rewrite them at 4096-d."""
    from icl.data.embeddings import EmbeddingStore
    from icl.data.imagebatch import AffinityBatcher
    from icl.data.pipeline import load_affinity_dataset
    from icl.io.boxes import read_box_feats, write_box_feats
    from icl.testing.synth import SynthConfig, generate_dataset

    d = str(tmp_path)
    generate_dataset(d, "train", SynthConfig(num_images=6, emb_dim=EMB_D,
                                             vocab_size=VOCAB, seed=seed))
    path = f"{d}/train.boxes.npz"
    ids, feats = read_box_feats(path)
    write_box_feats(path, ids, np.random.default_rng(seed).normal(
        size=(len(ids), BOX_D)).astype(np.float32))
    emb = EmbeddingStore.load(f"{d}/embeddings.txt")
    ds = load_affinity_dataset(d, "train", emb)
    assert ds.box_dim == BOX_D
    b = next(iter(AffinityBatcher(images_per_batch=4).batches(ds)))
    return emb.table, b.arrays


def _table(seed=1):
    return np.random.default_rng(seed).normal(
        size=(VOCAB, EMB_D)).astype(np.float32)


def _jax_model(phrase_enc, **kw):
    return JaxAffinityModel(lstm_hidden=LSTM_H, head_hidden=HEAD_H,
                            phrase_enc=phrase_enc, **kw)


def _jax_params(phrase_enc, table, arrays, key=5):
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    return _jax_model(phrase_enc).init(jax.random.PRNGKey(key),
                                       jnp.asarray(table), jb)["params"]


def _port(phrase_enc, params, fused, emb_dim=EMB_D, box_dim=BOX_D):
    model = AffinityModel(emb_dim, box_dim, LSTM_H, HEAD_H,
                          phrase_enc=phrase_enc, fused=fused)
    model.load_flat({k: torch.from_numpy(v.copy())
                     for k, v in flatten_params(params).items()})
    return model


def _torch(arrays):
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


# --- weights ---------------------------------------------------------------

@pytest.mark.parametrize("phrase_enc", ENCODERS)
def test_jax_tree_roundtrips_byte_identically(tmp_path, phrase_enc):
    arrays = affinity_batch()
    params = _jax_params(phrase_enc, _table(), arrays)
    want = dict(sorted(flatten_params(params).items()))
    dims = {"emb_dim": EMB_D, "lstm_hidden": LSTM_H, "head_hidden": HEAD_H,
            "box_dim": BOX_D, "phrase_enc": phrase_enc}
    assert {k: v.shape for k, v in want.items()} == affinity_param_shapes(
        dims)
    out = str(tmp_path / "affinity.npz")
    np.savez(out, **want)
    with open(out + ".manifest.json", "w") as f:
        json.dump({"step": 0, "params": {
            k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in want.items()}}, f)

    flat, _ = load_npz(out)
    port = AffinityModel(EMB_D, BOX_D, LSTM_H, HEAD_H, phrase_enc=phrase_enc)
    port.load_flat(flat)
    back = to_numpy(port.flat_params())
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert back[k].tobytes() == v.tobytes(), k

    # and the port's own archive: export format, model_config, same bytes
    path = str(tmp_path / "port.npz")
    manifest = save_npz(path, flat, {"task": "affinity", **dims})
    assert manifest["model_config"]["box_dim"] == BOX_D
    again, _ = load_npz(path)
    assert all(again[k].numpy().tobytes() == want[k].tobytes() for k in want)


@pytest.mark.parametrize("phrase_enc", ENCODERS)
def test_init_params_affinity_full_width(phrase_enc):
    dims = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 1024,
            "box_dim": 4096, "phrase_enc": phrase_enc}
    flat = init_params("affinity", 0, dims)
    table = jax.ShapeDtypeStruct((50, 300), jnp.float32)
    jb = jax.tree.map(lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype),
                      affinity_batch(D=4096))
    shapes = jax.eval_shape(JaxAffinityModel(phrase_enc=phrase_enc).init,
                            jax.random.PRNGKey(0), table, jb)["params"]
    want = {"/".join(p.key for p in path): leaf.shape for path, leaf
            in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    assert all(v.dtype == torch.float32 for v in flat.values())
    assert not flat["head_dense_phrase/bias"].any()
    Wb = flat["head_dense_box/kernel"]
    assert Wb.abs().max() <= 2 * np.sqrt(1 / 4096) / 0.8796256610342398
    assert abs(Wb.std().item() - np.sqrt(1 / 4096)) < 1e-4      # lecun
    if phrase_enc == "lstm":
        H = 200
        bias = flat["phrase_lstm/bias"]
        assert torch.equal(bias[H:2 * H], torch.ones(H))          # forget
        R = flat["phrase_lstm/recurrent_kernel"].double()
        torch.testing.assert_close(R @ R.T, torch.eye(H).double(),
                                   rtol=0, atol=1e-5)             # orthogonal
        assert flat["phrase_lstm/kernel"].abs().max() <= np.sqrt(6 / 1100)
    again = init_params("affinity", 0, dims)
    assert all(torch.equal(flat[k], again[k]) for k in flat)


# --- predict ---------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("phrase_enc", ENCODERS)
@pytest.mark.parametrize("source", ["synth", "batcher"])
def test_affinity_probs_match_jax(tmp_path, source, phrase_enc, fused):
    if source == "synth":
        table, arrays = _table(), affinity_batch()
    else:
        table, arrays = batcher_batch(tmp_path)
    params = _jax_params(phrase_enc, table, arrays)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    want = np.asarray(make_affinity_predict(_jax_model(phrase_enc).apply)(
        params, jnp.asarray(table), jb))
    model = _port(phrase_enc, params, fused)
    got = affinity_predict(model, torch.from_numpy(table),
                           _torch(arrays)).numpy()
    assert got.shape == want.shape
    _close(got, want, "probs")
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_zero_length_phrases_encode_to_zeros():
    arrays = affinity_batch()
    table = _table()
    for enc in ENCODERS:
        model = _port(enc, _jax_params(enc, table, arrays), fused=False)
        X, _ = model.project(torch.from_numpy(table), _torch(arrays))
        zero = torch.from_numpy(arrays["phrase_len"] == 0)
        # a length-0 phrase encodes to zeros: its X row is 0 @ Wp = 0
        assert not X[zero].any()


# --- K9, the box ranking -----------------------------------------------------

def _rank_problem(G, A, B, K, seed=0, empty_image=False):
    rng = np.random.default_rng(seed)
    f = np.float32
    args = [rng.normal(size=(G, A, K)).astype(f),
            rng.normal(size=(G, B, K)).astype(f),
            rng.normal(size=(K,)).astype(f),
            rng.normal(size=(K, 2)).astype(f),
            rng.normal(size=(2,)).astype(f)]
    valid = rng.random((G, B)) < 0.8
    valid[:, 0] = True
    if empty_image:
        valid[-1] = False
    return args, valid


RANK_SHAPES = [(2, 8, 16, 32, False), (1, 5, 7, 24, False),
               (2, 33, 12, 16, False), (3, 6, 9, 16, True),
               # the tile routine's edges: one box, a ragged 4 x 4 tile, more
               # boxes than 8 column tiles, K % 4 != 0
               (2, 12, 1, 16, False), (2, 1, 20, 16, True),
               (2, 17, 33, 24, True), (1, 12, 100, 16, False),
               (2, 16, 32, 30, True)]


@pytest.mark.parametrize("G,A,B,K,empty_image", RANK_SHAPES)
def test_rank_plain_matches_jax_kernel(G, A, B, K, empty_image):
    from jax.experimental.pallas import tpu as pltpu
    from icl.ops.affinity_rank import affinity_rank_pallas

    args, valid = _rank_problem(G, A, B, K, empty_image=empty_image)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(affinity_rank_pallas(
            *map(jnp.asarray, args), jnp.asarray(valid)))
    targs = [torch.from_numpy(a) for a in args]
    tvalid = torch.from_numpy(valid)
    got = affinity_rank_reference(*targs, tvalid).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(affinity_rank(*targs, tvalid),
                       affinity_rank_reference(*targs, tvalid))
    rows = got.sum(-1)
    np.testing.assert_allclose(rows[valid.any(-1)], 1.0, atol=1e-5)
    assert (got[~np.broadcast_to(valid[:, None, :], got.shape)] == 0).all()
    if empty_image:
        assert not got[-1].any() and np.isfinite(got).all()


@pytest.mark.parametrize("shape", [(0, 4, 5), (2, 0, 5), (2, 4, 0)])
def test_rank_empty_grid(shape):
    G, A, B = shape
    K = 8
    args = [torch.zeros(G, A, K), torch.zeros(G, B, K), torch.zeros(K),
            torch.zeros(K, 2), torch.zeros(2)]
    out = affinity_rank(*args, torch.zeros(G, B, dtype=torch.bool))
    assert out.shape == (G, A, B)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("phrase_enc", ENCODERS)
def test_affinity_predict_rank_matches_jax(phrase_enc, fused):
    table, arrays = _table(), affinity_batch(seed=4)
    params = _jax_params(phrase_enc, table, arrays)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    logits = _jax_model(phrase_enc).apply({"params": params},
                                          jnp.asarray(table), jb,
                                          deterministic=True)
    want_probs = np.asarray(jax.nn.softmax(logits, axis=-1))
    want_rank = np.asarray(jax_rank_boxes(logits, jb["box_valid"]))
    model = _port(phrase_enc, params, fused)
    probs, ranking = affinity_predict(model, torch.from_numpy(table),
                                      _torch(arrays), rank=True)
    _close(probs.numpy(), want_probs, "probs")
    _close(ranking.numpy(), want_rank, "rank")
    valid = arrays["box_valid"]
    assert not ranking.numpy()[~np.broadcast_to(valid[:, None, :],
                                                ranking.shape)].any()
    assert not ranking[2].any() and not ranking[3].any()    # no valid box


def test_rank_boxes_matches_jax():
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(3, 4, 5, 2)) * 4).astype(np.float32)
    valid = rng.random((3, 5)) < 0.6
    valid[2] = False
    got = rank_boxes(torch.from_numpy(logits), torch.from_numpy(valid))
    want = jax_rank_boxes(jnp.asarray(logits), jnp.asarray(valid))
    _close(got.numpy(), want, "rank_boxes")
    assert not got[2].any()
