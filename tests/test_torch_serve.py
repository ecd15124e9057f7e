"""icl_torch.serve on the CPU: HTTP relation scoring vs JAX predict.

The data dir holds a small synthetic dataset's word vectors and
JAX-initialised relation weights (lstm 8, head 16) written as an
``icl-export`` archive.  The served probabilities match JAX
``make_relation_predict`` on the same padded arrays within 1e-5 (the
response rounds to 6 decimals, so 5e-7 of that is rounding).

Further down: ``/score/nonvisual`` and ``/score/cardinality`` against
``icl.serve.Scorer`` from the same trained weights, and one server over the
port's own model dirs answering all four endpoints.
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


def test_the_reference_flag_compilation_cache_dir_is_taken_and_logged(
        monkeypatch):
    """``icl-serve --compilation_cache_dir d`` is a reference command line
    (``icl/serve.py``); the port accepts it and says that nothing is
    cached."""
    from icl_torch import serve as tserve

    said = []
    monkeypatch.setattr(tserve.LOG, "info",
                        lambda msg, *a: said.append(msg % a if a else msg))
    args = tserve.parse_args(["--data_dir", "d", "--compilation_cache_dir",
                              "/x", "--device", "cpu"])
    assert args.compilation_cache_dir == "/x" and args.data_dir == "d"
    assert any("--compilation_cache_dir /x" in s and "nothing to cache" in s
               for s in said), said
    said.clear()
    assert tserve.parse_args(["--data_dir", "d"]).compilation_cache_dir is None
    assert not said


# --- the mention endpoints, and a server over the port's model dirs ---------

MENTIONS = {"mentions": [
    {"id": "m0", "tokens": ["w001", "w002"]},
    {"tokens": ["w003"]},                              # id defaults to "1"
    {"id": "oov", "tokens": ["w004", "nosuchword", "w005"]},
    {"id": "empty", "tokens": []},
    {"id": "long", "tokens": [f"w{n:03d}" for n in range(1, 12)]}]}


@pytest.fixture(scope="module")
def four_tasks(tmp_path_factory):
    """The reference trains the two mention tasks (JAX on the CPU) and loads
    them into ``icl.serve.Scorer``; ``icl-export`` and ``icl-torch-import``
    carry them into the port's model dirs.  The port trains relation itself
    and takes affinity from an archive; one port server holds all four, and
    no ``.npz`` lies beside the three model dirs."""
    import shutil

    from icl.cli import cardinality as jcardinality
    from icl.cli import nonvisual as jnonvisual
    from icl.cli.export import export_checkpoint
    from icl.serve import Scorer as JaxScorer
    from icl_torch.cli import import_ as timport
    from icl_torch.cli import relation as trelation
    from icl_torch.params import init_params, save_npz
    from icl_torch.serve import serve
    from icl_torch.testing.synth import SynthConfig, generate_dataset

    root = tmp_path_factory.mktemp("torch_serve_four")
    jd, td = str(root / "jax"), str(root / "torch")
    generate_dataset(jd, "train", SynthConfig(num_images=6, seed=33,
                                              emb_dim=16, vocab_size=40))
    shutil.copytree(jd, td)
    for cli in (jnonvisual, jcardinality):
        cli.main(["--train", "--data_dir", jd, "--mesh", "1", "--epochs", "2",
                  "--hidden_width", "12", "--batch_size", "32"])
    for task in ("nonvisual", "cardinality"):
        export_checkpoint(f"{jd}/{task}.model", f"{root}/{task}.npz")
        timport.main(["--npz", f"{root}/{task}.npz", "--model_file",
                      f"{td}/{task}.model"])
    trelation.main(["--train", "--data_dir", td, "--device", "cpu",
                    "--epochs", "1", "--lstm_hidden_width", "8",
                    "--head_hidden", "16", "--images_per_batch", "4"])
    aff_dims = {"emb_dim": 16, "lstm_hidden": 8, "head_hidden": 16,
                "box_dim": 64}
    save_npz(f"{td}/affinity.npz", init_params("affinity", 0, aff_dims),
             {"task": "affinity", "phrase_enc": "lstm", **aff_dims})
    httpd = serve(td, port=0, device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield {"url": f"http://127.0.0.1:{httpd.server_port}", "httpd": httpd,
           "dir": td,
           "jax": JaxScorer(jd, tasks=["nonvisual", "cardinality"],
                            batch_window_ms=-1)}
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)


@pytest.mark.parametrize("task,classes", [
    ("nonvisual", ["visual", "nonvisual"]),
    ("cardinality", [str(i) for i in range(11)] + ["11+"])])
def test_score_mentions_matches_the_reference_scorer(four_tasks, task,
                                                     classes):
    status, body = _post(four_tasks["url"], f"/score/{task}", MENTIONS)
    want = four_tasks["jax"].score_mentions(task, MENTIONS)
    assert status == 200 and body["class_order"] == classes
    assert body["class_order"] == want["class_order"]
    assert [s["id"] for s in body["scores"]] == \
        [s["id"] for s in want["scores"]] == ["m0", "1", "oov", "empty",
                                              "long"]
    got = np.array([s["probs"] for s in body["scores"]])
    ref = np.array([s["probs"] for s in want["scores"]])
    assert got.shape == (5, len(classes))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert all(round(p, 6) == p for row in got.tolist() for p in row)
    # the same bytes again, and the scorer called directly
    assert _post(four_tasks["url"], f"/score/{task}", MENTIONS)[1] == body
    scorer = four_tasks["httpd"].RequestHandlerClass.scorer
    assert scorer.score_mentions(task, MENTIONS) == body


def test_one_server_answers_all_four_endpoints_from_model_dirs(four_tasks):
    d = four_tasks["dir"]
    for task in ("nonvisual", "cardinality", "relation"):
        names = os.listdir(f"{d}/{task}.model")
        assert any(n.startswith("step_") for n in names)
        assert not any(n.endswith(".npz") for n in names + os.listdir(d)
                       if task in n)
    assert _post(four_tasks["url"], "/score/relation",
                 {"images": [IMAGE]})[0] == 200
    boxes = np.random.default_rng(0).random((3, 64)).round(4).tolist()
    status, body = _post(four_tasks["url"], "/score/affinity", {"images": [
        {"id": "a", "phrases": [["w001"], ["w002", "w003"]], "boxes": boxes}]})
    assert status == 200 and np.array(body["images"][0]["grid"]).shape == (
        2, 3, 2)
    calls = dict(four_tasks["httpd"].RequestHandlerClass.scorer.stats)
    for task in ("nonvisual", "cardinality"):
        assert _post(four_tasks["url"], f"/score/{task}", MENTIONS)[0] == 200
    with urllib.request.urlopen(four_tasks["url"] + "/healthz") as r:
        health = json.loads(r.read())
    assert health["tasks"] == ["affinity", "cardinality", "nonvisual",
                               "relation"]
    co = health["coalescer"]
    assert co["mention_calls"] == calls["mention_calls"] + 2
    assert co["mention_items"] == calls["mention_items"] + 10
    assert co["device_calls"] == calls["device_calls"]   # not the coalescer
    assert set(health["latency_ms"]) >= {"nonvisual", "cardinality",
                                         "relation", "affinity"}
    for task in ("nonvisual", "cardinality"):
        lat = health["latency_ms"][task]
        assert lat["window"] >= 1 and 0 < lat["p50_ms"] <= lat["max_ms"]


def test_mention_request_limits_and_errors(four_tasks):
    handler = four_tasks["httpd"].RequestHandlerClass
    many = {"mentions": [{"tokens": ["w001"]}] * (handler.max_items + 1)}
    status, body = _post(four_tasks["url"], "/score/nonvisual", many)
    assert status == 413 and "limit" in body["error"]
    status, body = _post(four_tasks["url"], "/score/nonvisual",
                         {"images": []})
    assert status == 400 and "KeyError" in body["error"]
    status, body = _post(four_tasks["url"], "/score/nonvisual",
                         {"mentions": [{"id": "x"}]})
    assert status == 400
    status, body = _post(four_tasks["url"], "/score/nonvisual",
                         {"mentions": []})
    assert status == 200 and body["scores"] == []


def test_the_newest_checkpoint_wins_over_the_archive(four_tasks, tmp_path):
    """The order of the CLIs' predict: ``<task>.model/`` newest step, else
    ``<task>.npz``; a task with neither is skipped, none found raises."""
    import shutil

    from icl_torch.params import init_params, save_npz
    from icl_torch.serve import Scorer

    d = str(tmp_path)
    shutil.copy(f"{four_tasks['dir']}/embeddings.txt", d)
    with pytest.raises(FileNotFoundError, match="no <task>.model checkpoint"):
        Scorer(d, device="cpu", batch_window_ms=-1)
    other = init_params("nonvisual", 5, {"emb_dim": 16, "hidden": 12})
    save_npz(f"{d}/nonvisual.npz", other,
             {"task": "nonvisual", "hidden": 12})
    from_archive = Scorer(d, device="cpu", batch_window_ms=-1)
    assert sorted(from_archive.tasks) == ["nonvisual"]
    got = from_archive.tasks["nonvisual"]["model"].flat_params()
    assert all(torch.equal(got[k], other[k]) for k in other)
    os.makedirs(f"{d}/nonvisual.model")          # an empty model dir: archive
    assert sorted(Scorer(d, device="cpu", batch_window_ms=-1).tasks) == [
        "nonvisual"]
    shutil.rmtree(f"{d}/nonvisual.model")
    shutil.copytree(f"{four_tasks['dir']}/nonvisual.model",
                    f"{d}/nonvisual.model")
    from_dir = Scorer(d, device="cpu", batch_window_ms=-1)
    want = four_tasks["httpd"].RequestHandlerClass.scorer.tasks[
        "nonvisual"]["model"].flat_params()
    got = from_dir.tasks["nonvisual"]["model"].flat_params()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert any(not torch.equal(got[k], other[k]) for k in other)
    with pytest.raises(ValueError, match="unknown task"):
        Scorer(d, device="cpu", tasks=["grounding"])
