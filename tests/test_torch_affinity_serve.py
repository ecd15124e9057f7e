"""icl_torch.serve on the CPU: HTTP affinity scoring vs JAX predict, and
one server for both tasks.

The data dir holds a small synthetic dataset's word vectors and
JAX-initialised relation (lstm 8, head 16) and affinity (lstm 8, head 16,
12-d boxes) weights written as ``icl-export`` archives.  The served grid
matches JAX ``make_affinity_predict`` on the same padded arrays within 1e-5
(the response rounds to 6 decimals, so 5e-7 of that is rounding).
"""

import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

IMAGES = [
    {"id": "a0", "phrases": [["w001", "w002"], ["w003"], ["nope", "w004"]],
     "boxes": np.random.default_rng(0).normal(size=(5, 12)).tolist()},
    {"id": "a1", "phrases": [["w005", "w006", "w007"], []],
     "boxes": np.random.default_rng(1).normal(size=(2, 12)).tolist()},
]
RELATION_IMAGE = {"id": "r0", "captions": [["w001", "w002", "w003"],
                                           ["w004", "w005"]],
                  "mentions": [{"caption": 0, "first": 0, "last": 1},
                               {"caption": 1, "first": 0, "last": 0}]}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from icl.cli.export import flatten_params
    from icl.data.embeddings import EmbeddingStore
    from icl.models import AffinityModel as JaxAffinityModel
    from icl.models import RelationModel as JaxRelationModel
    from icl.testing.synth import SynthConfig, generate_dataset
    from icl.train.steps import make_affinity_predict
    from icl_torch.params import save_npz
    from icl_torch.serve import (_empty_affinity_batch, _empty_relation_batch,
                                 serve)

    d = str(tmp_path_factory.mktemp("torch_serve_affinity"))
    generate_dataset(d, "train", SynthConfig(num_images=2, emb_dim=10,
                                             seed=41))
    table = jnp.asarray(EmbeddingStore.load(
        os.path.join(d, "embeddings.txt")).table)

    def jb(batch):
        return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    amodel = JaxAffinityModel(lstm_hidden=8, head_hidden=16)
    aparams = amodel.init(jax.random.PRNGKey(3), table, jb(
        _empty_affinity_batch(1, 8, 4, 4, 12, "cpu")))["params"]
    rparams = JaxRelationModel(lstm_hidden=8, head_hidden=16).init(
        jax.random.PRNGKey(4), table,
        jb(_empty_relation_batch(1, 4, 8, 4, "cpu")))["params"]
    for task, params in (("affinity", aparams), ("relation", rparams)):
        save_npz(os.path.join(d, f"{task}.npz"),
                 {k: torch.from_numpy(v.copy())
                  for k, v in flatten_params(params).items()},
                 {"task": task, "lstm_hidden": 8, "head_hidden": 16,
                  "emb_dim": 10, "box_dim": 12, "phrase_enc": "lstm"})
    httpd = serve(d, port=0, device=torch.device("cpu"))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    predict = make_affinity_predict(amodel.apply)
    yield {"url": f"http://127.0.0.1:{httpd.server_port}", "httpd": httpd,
           "data_dir": d,
           "jax_predict": lambda b: np.asarray(predict(aparams, table, b))}
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


def _post(url, path, obj):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_score_affinity_matches_jax(served):
    scorer = served["httpd"].RequestHandlerClass.scorer
    status, body = _post(served["url"], "/score/affinity",
                         {"images": IMAGES})
    assert status == 200
    assert body["class_order"] == ["no_affinity", "affinity"]
    assert [im["id"] for im in body["images"]] == ["a0", "a1"]
    for img, sent in zip(body["images"], IMAGES):
        prepped = scorer._prep_affinity_image(sent)
        batch = scorer._stack_arrays([prepped[1]])
        want = served["jax_predict"]({k: jnp.asarray(v.numpy())
                                      for k, v in batch.items()})[0]
        n_ph, n_box = len(sent["phrases"]), len(sent["boxes"])
        got = np.array(img["grid"])
        assert got.shape == (n_ph, n_box, 2)
        np.testing.assert_allclose(got, want[:n_ph, :n_box], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_one_server_serves_both_tasks(served):
    status, body = _post(served["url"], "/score/relation",
                         {"images": [RELATION_IMAGE]})
    assert status == 200 and len(body["images"][0]["pairs"]) == 1
    assert _post(served["url"], "/score/affinity",
                 {"images": IMAGES[:1]})[0] == 200
    with urllib.request.urlopen(served["url"] + "/healthz") as r:
        health = json.loads(r.read())
    assert health["tasks"] == ["affinity", "relation"]
    for task in ("affinity", "relation"):
        lat = health["latency_ms"][task]
        assert lat["window"] >= 1
        assert 0 < lat["p50_ms"] <= lat["p99_ms"] <= lat["max_ms"]


def test_unknown_task_is_404(served):
    status, body = _post(served["url"], "/score/nonvisual",
                         {"mentions": [{"tokens": ["w001"]}]})
    assert status == 404
    assert body == {"error": "unknown or unloaded task 'nonvisual'",
                    "tasks": ["affinity", "relation"]}


def test_bad_box_width_is_400(served):
    img = dict(IMAGES[0], boxes=[[0.0] * 7])
    status, body = _post(served["url"], "/score/affinity", {"images": [img]})
    assert status == 400 and "boxes must be" in body["error"]


def test_tasks_subset_and_missing_archives(served, tmp_path):
    from icl_torch.serve import Scorer

    scorer = Scorer(served["data_dir"], device=torch.device("cpu"),
                    batch_window_ms=-1, tasks=["affinity"])
    assert sorted(scorer.tasks) == ["affinity"]
    assert scorer.warmup("basic") == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    shutil.copy(os.path.join(served["data_dir"], "embeddings.txt"), empty)
    with pytest.raises(FileNotFoundError, match="no <task>.npz"):
        Scorer(str(empty), device=torch.device("cpu"), batch_window_ms=-1)


def test_affinity_scorer_needs_a_card_or_device_cpu(served, monkeypatch):
    from icl_torch.serve import Scorer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scorer(served["data_dir"], batch_window_ms=-1, tasks=["affinity"])
    scorer = Scorer(served["data_dir"], device="cpu", batch_window_ms=-1,
                    tasks=["affinity"])
    assert scorer.device.type == "cpu" and sorted(scorer.tasks) == ["affinity"]
    assert scorer.warmup("basic") == 2
