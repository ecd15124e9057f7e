"""icl_torch.serve on the CPU: HTTP relation scoring vs JAX predict.

The data dir holds a small synthetic dataset's word vectors and
JAX-initialised relation weights (lstm 8, head 16) written as an
``icl-export`` archive.  The served probabilities match JAX
``make_relation_predict`` on the same padded arrays within 1e-5 (the
response rounds to 6 decimals, so 5e-7 of that is rounding).
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = {"id": "img0",
         "captions": [["w001", "w002", "w003", "w004"], ["w005", "w001"],
                      ["w010", "w011", "w012"]],
         "mentions": [{"caption": 0, "first": 0, "last": 1},
                      {"caption": 1, "first": 1, "last": 1},
                      {"caption": 2, "first": 0, "last": 2}]}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    from icl.cli.export import flatten_params
    from icl.data.embeddings import EmbeddingStore
    from icl.models import RelationModel as JaxRelationModel
    from icl.testing.synth import SynthConfig, generate_dataset
    from icl.train.steps import make_relation_predict
    from icl_torch.params import save_npz
    from icl_torch.serve import _empty_relation_batch, serve

    d = str(tmp_path_factory.mktemp("torch_serve"))
    generate_dataset(d, "train", SynthConfig(num_images=2, seed=31))
    table = jnp.asarray(EmbeddingStore.load(
        os.path.join(d, "embeddings.txt")).table)
    jmodel = JaxRelationModel(lstm_hidden=8, head_hidden=16)
    jb = {k: jnp.asarray(v.numpy()) for k, v in
          _empty_relation_batch(1, 4, 8, 4, "cpu").items()}
    params = jmodel.init(jax.random.PRNGKey(7), table, jb)["params"]
    save_npz(os.path.join(d, "relation.npz"),
             {k: torch.from_numpy(v.copy())
              for k, v in flatten_params(params).items()},
             {"task": "relation", "lstm_hidden": 8, "head_hidden": 16})
    httpd = serve(d, port=0, device=torch.device("cpu"))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    predict = make_relation_predict(jmodel.apply)
    yield {"url": f"http://127.0.0.1:{httpd.server_port}", "httpd": httpd,
           "data_dir": d,
           "jax_predict": lambda b: np.asarray(predict(params, table, b))}
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


def test_score_relation_matches_jax(served):
    scorer = served["httpd"].RequestHandlerClass.scorer
    images = [IMAGE, dict(IMAGE, id="img1", pairs=[[2, 0], [1, 1]])]
    status, body = _post(served["url"], "/score/relation",
                         {"images": images})
    assert status == 200
    assert body["class_order"] == ["null", "coref", "subset_ij", "subset_ji"]
    assert [im["id"] for im in body["images"]] == ["img0", "img1"]
    prepped = [scorer._prep_relation_image(img) for img in images]
    batch = scorer._stack_arrays([p[1] for p in prepped])
    want = served["jax_predict"]({k: jnp.asarray(v.numpy())
                                  for k, v in batch.items()})
    for i, (img, (_, _, pairs)) in enumerate(zip(body["images"], prepped)):
        assert [p["pair"] for p in img["pairs"]] == pairs
        got = np.array([p["probs"] for p in img["pairs"]])
        np.testing.assert_allclose(got, want[i, :len(pairs)], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_healthz_counts_and_latency(served):
    scorer = served["httpd"].RequestHandlerClass.scorer
    calls0 = scorer.stats["device_calls"]
    assert _post(served["url"], "/score/relation",
                 {"images": [IMAGE] * 3})[0] == 200
    with urllib.request.urlopen(served["url"] + "/healthz") as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["tasks"] == ["relation"]
    assert body["coalescer"]["device_calls"] >= calls0 + 1
    assert body["coalescer"]["items"] >= body["coalescer"]["device_calls"]
    lat = body["latency_ms"]["relation"]
    assert lat["window"] >= 1
    assert 0 < lat["p50_ms"] <= lat["p99_ms"] <= lat["max_ms"]


@pytest.mark.parametrize("mention,match", [
    ({"caption": 0, "first": 2, "last": 1}, "bad mention span"),
    ({"caption": 5, "first": 0, "last": 0}, "out of range")])
def test_bad_span_is_400(served, mention, match):
    img = dict(IMAGE, mentions=IMAGE["mentions"] + [mention])
    status, body = _post(served["url"], "/score/relation", {"images": [img]})
    assert status == 400 and match in body["error"]


def test_over_max_items_is_413(served):
    handler = served["httpd"].RequestHandlerClass
    n = handler.max_items + 1
    status, body = _post(served["url"], "/score/relation",
                         {"images": [IMAGE] * n})
    assert status == 413 and "limit" in body["error"]


def test_concurrent_requests_coalesce(served):
    scorer = served["httpd"].RequestHandlerClass.scorer
    co = scorer.coalescer
    calls0 = scorer.stats["device_calls"]
    old_window, co.window = co.window, 0.25
    results = [None] * 4

    def fire(k):
        results[k] = _post(served["url"], "/score/relation",
                           {"images": [dict(IMAGE, id=f"c{k}")]})

    try:
        threads = [threading.Thread(target=fire, args=(k,))
                   for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        co.window = old_window
    assert all(r is not None and r[0] == 200 for r in results)
    probs = [r[1]["images"][0]["pairs"] for r in results]
    assert all(p == probs[0] for p in probs)
    assert scorer.stats["device_calls"] - calls0 < 4


def test_sigterm_drains_and_exits_clean(served):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen(
        [sys.executable, "-u", "-m", "icl_torch.serve", "--data_dir",
         served["data_dir"], "--warmup", "off", "--port", "0", "--device",
         "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    t = threading.Thread(target=lambda: lines.extend(
        iter(p.stdout.readline, "")), daemon=True)
    t.start()
    try:
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            for ln in list(lines):
                m = re.search(r"listening on 127\.0\.0\.1:(\d+)", ln)
                if m:
                    port = int(m.group(1))
            time.sleep(0.1)
        assert port, "".join(lines)
        status, _ = _post(f"http://127.0.0.1:{port}", "/score/relation",
                          {"images": [IMAGE]})
        assert status == 200
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 0, "".join(lines)
    finally:
        if p.poll() is None:
            p.kill()
    t.join(timeout=10)
    out = "".join(lines)
    assert "shutting down" in out and "drained, exiting" in out, out
    assert "Traceback" not in out, out


def test_scorer_runs_on_the_card_unless_asked_for_the_cpu(served, monkeypatch):
    from icl_torch.serve import Scorer, serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scorer(served["data_dir"], batch_window_ms=-1)
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve(served["data_dir"], port=0, warmup="off")
    scorer = Scorer(served["data_dir"], device="cpu", batch_window_ms=-1)
    assert scorer.device.type == "cpu"
    body = scorer.score_relation({"images": [IMAGE]})
    status, want = _post(served["url"], "/score/relation", {"images": [IMAGE]})
    assert status == 200 and body == want


def test_cli_without_a_card_refuses_to_start(served):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "icl_torch.serve", "--data_dir",
         served["data_dir"], "--warmup", "off", "--port", "0"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
