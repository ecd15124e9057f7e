"""icl_torch relation predict vs JAX make_relation_predict (CPU, f32).

JAX-initialised weights (lstm 8, head 16) go to the port through the
``icl-export`` flat keys; both sides score the same padded numpy batch.
Probabilities agree within 1e-5, in the port's gather form and in its fused
form (grid head + pair-cell gather; on the CPU its wrappers run their plain
versions).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _synth_relation_batch
from icl.cli.export import flatten_params
from icl.models import RelationModel as JaxRelationModel
from icl.train.steps import make_relation_predict
from icl_torch.models.relation import RelationModel
from icl_torch.train.steps import relation_predict

LSTM_H, HEAD_H = 8, 16


def _synth(emb):
    rng = np.random.default_rng(11)
    b = _synth_relation_batch(rng, I=3, C=4, L=10, M=6,
                              vocab=emb.table.shape[0])
    return {k: np.asarray(v) for k, v in b.items()}


def _batcher(emb, synth_dir):
    from icl.data.imagebatch import RelationBatcher
    from icl.data.pipeline import load_relation_dataset

    ds = load_relation_dataset(synth_dir, "train", emb)
    # 3 images in a batch of 4: the last image slot is padding
    # (length-0 captions, no mentions)
    batcher = RelationBatcher(images_per_batch=4, build_grid=False)
    return next(iter(batcher.batches(ds))).arrays


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("source", ["synth", "batcher"])
def test_relation_probs_match_jax(emb, synth_dir, source, fused):
    arrays = _synth(emb) if source == "synth" else _batcher(emb, synth_dir)
    table = jnp.asarray(emb.table)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    jmodel = JaxRelationModel(lstm_hidden=LSTM_H, head_hidden=HEAD_H)
    params = jmodel.init(jax.random.PRNGKey(5), table, jb)["params"]
    want = np.asarray(make_relation_predict(jmodel.apply)(params, table, jb))

    model = RelationModel(emb.dim, LSTM_H, HEAD_H, fused=fused)
    model.load_flat({k: torch.from_numpy(v.copy())
                     for k, v in flatten_params(params).items()})
    got = relation_predict(model, torch.from_numpy(emb.table),
                           {k: torch.from_numpy(np.array(v))
                            for k, v in arrays.items()}).numpy()
    assert got.shape == want.shape
    valid = arrays["pair_valid"]
    assert valid.any()
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
