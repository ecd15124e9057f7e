"""The port's command lines as ranks of one run (CPU, gloo): ``python -m
icl_torch.cli.<task> --coordinator localhost:<port> --num_processes N
--process_id k --device cpu`` on a shared model dir, against the same
command line as one process (run in this process).

What must hold (``tests/dist/test_cli_multiprocess.py`` names the cases for
the JAX package):

* ``--train`` writes ONE checkpoint tree, metrics stream and config dump
  (rank 0's), ends within 1e-6 of the one-process run (dropout 0.5: the
  masks are the global batch's), and ``--resume auto`` under two ranks ends
  bit-equal to the uninterrupted two-rank run;
* ``--eval_every`` with ``--early_stop`` stops every rank at one step;
* ``--predict`` merges to a ``.scores`` with the one-process file's ids in
  its order, probabilities within 2.1e-6 (one unit of the sixth decimal and
  its rounding: a rank's batches hold other images, so f32 sums associate
  differently), the global count in the sidecar, no part file left;
  ``--eval`` prints the one-process table once; the same for affinity with
  ``--rank_file``, a mention task, ``icl-torch-joint`` and four ranks with
  an empty slice;
* under ``--compute_dtype bf16`` two affinity ranks end within 1e-4 of one
  process (``BF16_RANKS_GATE``) and their sharded predict merges as above.

Every rank gets a 60 s process-group timeout and a bounded ``communicate``.
"""

import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from icl_torch.cli import affinity as affinity_cli
from icl_torch.cli import joint as joint_cli
from icl_torch.cli import nonvisual as nonvisual_cli
from icl_torch.cli import relation as relation_cli
from icl_torch.io.scores import read_scores
from icl_torch.testing.synth import SynthConfig, generate_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAINS = {"relation": relation_cli.main, "affinity": affinity_cli.main,
         "nonvisual": nonvisual_cli.main, "joint": joint_cli.main}
RANKS_GATE = 1e-6       # two ranks' weights vs one process's, absolute
SCORES_GATE = 2.1e-6    # merged probabilities vs one process's file
# two ranks' weights vs one process's under --compute_dtype bf16: each
# rank's LSTM gradient crosses the bf16 cast on its half batch, so the sum
# differs from the whole batch's by bf16 roundings, which Adam's first
# steps scale towards the learning rate (1e-3); measured 2.7e-05
BF16_RANKS_GATE = 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(task, argv, world=2, per_rank=None, timeout=240):
    """``world`` ranks of one command line; [(returncode, output)].
    ``per_rank(k)``: more flags for rank k."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, ICL_TORCH_DIST_TIMEOUT="60",
               OMP_NUM_THREADS="1")
    port = _free_port()     # ONE port a run: the ranks must meet
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"icl_torch.cli.{task}", *map(str, argv),
         "--coordinator", f"localhost:{port}", "--num_processes", str(world),
         "--process_id", str(k), *(per_rank(k) if per_rank else [])],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for k in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def _one(task, argv) -> str:
    """The command line as one process, here; what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        MAINS[task](list(map(str, argv)))
    return buf.getvalue()


def _table(out: str) -> str:
    """The ScoreDict block printed to stdout, logs stripped."""
    lines = out.splitlines()
    starts = [i for i, ln in enumerate(lines) if ln.startswith("label ")]
    ends = [i for i, ln in enumerate(lines) if ln.startswith("Accuracy:")]
    assert starts and ends, f"no ScoreDict table in:\n{out}"
    return "\n".join(lines[starts[0]:ends[-1] + 1])


def _latest(model_dir):
    steps = sorted(int(n[5:-3]) for n in os.listdir(model_dir)
                   if n.startswith("step_"))
    assert steps, f"no checkpoint in {model_dir}"
    return steps, torch.load(os.path.join(model_dir, f"step_{steps[-1]}.pt"),
                             weights_only=True)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat(dict(enumerate(tree)), prefix)
    return {prefix: tree}


def _assert_scores_equiv(a, b, atol=SCORES_GATE):
    ia, pa = read_scores(str(a))
    ib, pb = read_scores(str(b))
    assert ia == ib and len(ia) > 0
    np.testing.assert_allclose(pa, pb, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_cli_data")
    kw = dict(captions_per_image=2, vocab_size=40, emb_dim=12,
              max_mentions_per_caption=2, max_boxes_per_image=4)
    generate_dataset(str(d), "train", SynthConfig(num_images=16, seed=0, **kw))
    generate_dataset(str(d), "dev", SynthConfig(num_images=3, seed=1, **kw))
    return d


def _relation_train(data, model_dir, epochs, extra=()):
    return ["--train", "--data_dir", data, "--device", "cpu", "--epochs",
            epochs, "--images_per_batch", 8, "--lstm_hidden_width", 6,
            "--head_hidden", 12, "--ckpt_every", 3, "--seed", 7,
            "--model_file", model_dir, *extra]


def _relation_predict(data, model_dir, scores, split="train"):
    return ["--predict", "--eval", "--data_dir", data, "--device", "cpu",
            "--data_split", split, "--images_per_batch", 8,
            "--lstm_hidden_width", 6, "--head_hidden", 12, "--seed", 7,
            "--model_file", model_dir, "--scores_file", scores]


@pytest.fixture(scope="module")
def trained(data, tmp_path_factory):
    """Relation, dropout 0.5, 4 epochs of 2 steps: one process; two ranks
    straight through; two ranks stopped after 2 epochs and resumed."""
    tmp = tmp_path_factory.mktemp("dist_cli_train")
    ev = ["--eval_every", 2, "--eval_split", "train", "--eval_batches", 2]
    _one("relation", _relation_train(data, tmp / "single", 4, ev
                                     + ["--metrics_file", tmp / "s.jsonl"]))
    outs = _ranks("relation", _relation_train(data, tmp / "mp", 4, ev),
                  per_rank=lambda k: ["--metrics_file", tmp / f"mp{k}.jsonl"])
    _ranks("relation", _relation_train(data, tmp / "resumed", 2, ev))
    first = _latest(tmp / "resumed")
    resumed = _ranks("relation", _relation_train(
        data, tmp / "resumed", 4, ev + ["--resume", "auto"]))
    return {"tmp": tmp, "outs": outs, "resumed_outs": resumed,
            "first": first}


def test_cli_two_process_train_resume_matches(trained):
    tmp = trained["tmp"]
    steps_s, single = _latest(tmp / "single")
    steps_m, mp = _latest(tmp / "mp")
    steps_r, resumed = _latest(tmp / "resumed")
    assert steps_s == steps_m == [3, 6, 8]
    assert steps_r == [4, 6, 8]      # 4: the first run's end marker
    assert trained["first"][0] == [3, 4] and trained["first"][1]["epoch"] == 2
    assert all("resumed from checkpoint at step 4" in out
               for out in trained["resumed_outs"])
    assert all("replicate: the train state equal on all 2 ranks" in out
               for out in trained["outs"] + trained["resumed_outs"])
    a, b, c = _flat(single), _flat(mp), _flat(resumed)
    assert sorted(a) == sorted(b) == sorted(c) and len(a) > 20
    for k in a:
        if isinstance(a[k], torch.Tensor):
            # the resumed two-rank run: the uninterrupted one's bits
            assert torch.equal(b[k], c[k]), k
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(),
                                       atol=RANKS_GATE, rtol=0, err_msg=k)
        else:
            assert a[k] == b[k] == c[k], k
    moved = max(float((single["model"][k] - torch.load(
        tmp / "single" / "step_3.pt", weights_only=True)["model"][k]
    ).abs().max()) for k in single["model"])
    assert moved > 1e-3


def test_only_rank_0_writes(trained):
    tmp = trained["tmp"]
    # one writer: rank 1 was given a metrics path of its own and left none
    assert (tmp / "mp0.jsonl").exists() and not (tmp / "mp1.jsonl").exists()
    rows = [json.loads(x) for x in (tmp / "mp0.jsonl").read_text().splitlines()]
    want = [json.loads(x) for x in (tmp / "s.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [r["step"] for r in want] \
        == [2, 4, 6, 8]
    np.testing.assert_allclose([r["eval_loss"] for r in rows],
                               [r["eval_loss"] for r in want], atol=1e-5)
    assert sorted(os.listdir(tmp / "mp")) == [
        "model_config.json", "step_3.pt", "step_6.pt", "step_8.pt",
        "train_config.json"]
    cfg = json.load(open(tmp / "mp" / "train_config.json"))
    assert cfg["_num_devices"] == 2 and cfg["_reduce_backend"] == "gloo"
    assert cfg["_mesh"] == {"data": 2, "model": 1} and cfg["process_id"] == 0
    # the resolved precision, recorded once (rank 0 writes the file): the
    # --train default, exact kernels on the CPU
    assert (cfg["_matmul_precision"], cfg["_tf32"], cfg["_head_exact"]) == (
        "default", False, True)
    one = json.load(open(tmp / "single" / "train_config.json"))
    assert one["_num_devices"] == 1 and one["_reduce_backend"] is None
    # every rank logged the backend it was given, and its own all-reduces
    for out in trained["outs"]:
        assert "gradient and eval sums over gloo" in out
        assert "all-reduce (gloo):" in out


def test_cli_two_process_predict_merges(data, trained, tmp_path):
    model = trained["tmp"] / "mp"
    s1, s2 = tmp_path / "single.scores", tmp_path / "multi.scores"
    table_s = _table(_one("relation", _relation_predict(data, model, s1)))
    outs = _ranks("relation", _relation_predict(data, model, s2))
    _assert_scores_equiv(s2, s1)
    # each rank counted its own image slice: ONE rank prints the merged
    # table, and it is the one-process table
    tables = [_table(out) for out in outs if "Accuracy:" in out]
    assert len(tables) == 1 and tables[0] == table_s
    assert all("sharded predict: process" in out for out in outs)
    assert not list(tmp_path.glob("*.sdpart-*")), "sd parts not cleaned up"
    assert not list(tmp_path.glob("*.part-*")), "part files not cleaned up"
    meta = json.loads((tmp_path / "multi.scores.meta.json").read_text())
    assert meta["num_examples"] == len(s1.read_text().splitlines())
    assert meta["checkpoint_step"] == 8 and meta["task"] == "relation"


def test_cli_two_process_eval_early_stop_matches(data, tmp_path):
    """At learn_rate 0.02 and seed 1 the three dev images' loss turns after
    step 4 (1.16, 1.05, 1.08, 1.11 one process: margins of 0.03, far above
    the sums' reassociation), so the stop fires at step 8 and restores step
    4; every rank must stop there and restore that state, within 1e-6 of
    one process's.  (The other tests' seed 7 draws one recurrent weight
    whose gradient lies near Adam's eps of 1e-8, where the reassociation
    shows in the update at this rate: 1e-4 after four steps.)"""
    ex = ["--eval_every", 2, "--eval_split", "dev", "--eval_batches", 2,
          "--early_stop", 2, "--learn_rate", 0.02, "--dropout", 0.0,
          "--seed", 1]
    _one("relation", _relation_train(data, tmp_path / "s", 10, ex + [
        "--metrics_file", tmp_path / "s.jsonl"]))
    steps_s, single = _latest(tmp_path / "s")
    assert steps_s[-1] == 4           # stopped before the cap, tail pruned
    outs = _ranks("relation", _relation_train(data, tmp_path / "mp", 10, ex + [
        "--metrics_file", tmp_path / "mp.jsonl"]))
    stops = [ln.split("early stop at step ")[1].split(":")[0]
             for out in outs for ln in out.splitlines()
             if "early stop at step" in ln]
    assert stops == ["8", "8"]
    steps_m, mp = _latest(tmp_path / "mp")
    assert steps_m == steps_s and mp["step"] == single["step"]
    for k, v in single["model"].items():
        np.testing.assert_allclose(mp["model"][k].numpy(), v.numpy(),
                                   atol=RANKS_GATE, rtol=0, err_msg=k)

    def evals(p):
        return [x for x in map(json.loads, p.read_text().splitlines())
                if "eval_loss" in x]
    ev_m, ev_s = evals(tmp_path / "mp.jsonl"), evals(tmp_path / "s.jsonl")
    assert [e["step"] for e in ev_m] == [e["step"] for e in ev_s]
    np.testing.assert_allclose([e["eval_loss"] for e in ev_m],
                               [e["eval_loss"] for e in ev_s], atol=1e-4)


def test_cli_two_process_affinity_train_and_predict_with_rank(data, tmp_path):
    """Another schema (grid cells, box features) and a second sharded
    artifact: ``--rank_file`` merges as the ``.scores`` does."""
    common = ["--data_dir", data, "--device", "cpu", "--images_per_batch", 8,
              "--lstm_hidden_width", 6, "--head_hidden", 12, "--seed", 7]
    _one("affinity", ["--train", "--epochs", 2, *common, "--model_file",
                      tmp_path / "s"])
    _ranks("affinity", ["--train", "--epochs", 2, *common, "--model_file",
                        tmp_path / "m"])
    (steps_s, single), (steps_m, mp) = _latest(tmp_path / "s"), \
        _latest(tmp_path / "m")
    assert steps_s == steps_m
    for k, v in single["model"].items():
        np.testing.assert_allclose(mp["model"][k].numpy(), v.numpy(),
                                   atol=RANKS_GATE, rtol=0, err_msg=k)
    base = ["--predict", *common, "--model_file", tmp_path / "m"]
    _one("affinity", base + ["--scores_file", tmp_path / "s.scores",
                             "--rank_file", tmp_path / "s.rank"])
    _ranks("affinity", base + ["--scores_file", tmp_path / "m.scores",
                               "--rank_file", tmp_path / "m.rank"])
    _assert_scores_equiv(tmp_path / "m.scores", tmp_path / "s.scores")
    _assert_scores_equiv(tmp_path / "m.rank", tmp_path / "s.rank")
    assert not list(tmp_path.glob("*.part-*"))
    meta = json.loads((tmp_path / "m.rank.meta.json").read_text())
    assert meta["task"] == "affinity_rank" and meta["num_examples"] == len(
        (tmp_path / "s.rank").read_text().splitlines())


def test_cli_two_process_bf16_affinity_train_and_predict(data, tmp_path):
    """``--compute_dtype bf16`` under a mesh: two ranks train affinity in
    bf16 (bf16 boxes cross to each rank's device; the gradients, their
    all-reduce and the weights stay f32) to the one-process run's weights,
    and the sharded bf16 predict merges to its files."""
    common = ["--data_dir", data, "--device", "cpu", "--images_per_batch", 8,
              "--lstm_hidden_width", 6, "--head_hidden", 12, "--seed", 7,
              "--fused", "on", "--compute_dtype", "bf16"]
    _one("affinity", ["--train", "--epochs", 2, *common, "--model_file",
                      tmp_path / "s"])
    _ranks("affinity", ["--train", "--epochs", 2, *common, "--model_file",
                        tmp_path / "m"])
    (steps_s, single), (steps_m, mp) = _latest(tmp_path / "s"), \
        _latest(tmp_path / "m")
    assert steps_s == steps_m
    for k, v in single["model"].items():
        assert v.dtype == mp["model"][k].dtype == torch.float32, k
        np.testing.assert_allclose(mp["model"][k].numpy(), v.numpy(),
                                   atol=BF16_RANKS_GATE, rtol=0, err_msg=k)
    base = ["--predict", *common, "--model_file", tmp_path / "m"]
    _one("affinity", base + ["--scores_file", tmp_path / "s.scores",
                             "--rank_file", tmp_path / "s.rank"])
    _ranks("affinity", base + ["--scores_file", tmp_path / "m.scores",
                               "--rank_file", tmp_path / "m.rank"])
    _assert_scores_equiv(tmp_path / "m.scores", tmp_path / "s.scores")
    _assert_scores_equiv(tmp_path / "m.rank", tmp_path / "s.rank")


def test_cli_two_process_mention_train_and_predict(data, tmp_path):
    """The flat mention rows are a third schema: every rank builds the
    global batch and feeds its row slice; predict slices the rows.  Batch
    size 15 is rounded up to the data axis."""
    common = ["--data_dir", data, "--device", "cpu", "--hidden_width", 8,
              "--seed", 7]
    _one("nonvisual", ["--train", "--epochs", 3, "--batch_size", 16, *common,
                       "--model_file", tmp_path / "s"])
    outs = _ranks("nonvisual", ["--train", "--epochs", 3, "--batch_size", 15,
                                *common, "--model_file", tmp_path / "m"])
    assert all("batch_size rounded to 16 for 2 devices" in o for o in outs)
    (steps_s, single), (steps_m, mp) = _latest(tmp_path / "s"), \
        _latest(tmp_path / "m")
    assert steps_s == steps_m
    for k, v in single["model"].items():
        np.testing.assert_allclose(mp["model"][k].numpy(), v.numpy(),
                                   atol=RANKS_GATE, rtol=0, err_msg=k)
    base = ["--predict", "--eval", "--batch_size", 16, *common,
            "--model_file", tmp_path / "m"]
    table_s = _table(_one("nonvisual", base + ["--scores_file",
                                               tmp_path / "s.scores"]))
    outs = _ranks("nonvisual", base + ["--scores_file", tmp_path / "m.scores"])
    _assert_scores_equiv(tmp_path / "m.scores", tmp_path / "s.scores")
    tables = [_table(out) for out in outs if "Accuracy:" in out]
    assert tables == [table_s]


def test_cli_two_process_joint_forwards_bootstrap(data, tmp_path):
    """The wrapper forwards the bootstrap flags, so each sub-run sweeps its
    slice (dropping them would leave every process sweeping the FULL split
    and racing on one path), and ``runtime.init`` is re-entered in the same
    process by every sub-run after the first.  Predict from the initial
    weights: equal seeds, equal weights, no training needed."""
    tasks = ("nonvisual", "relation", "affinity")
    base = ["--predict", "--data_split", "train", "--device", "cpu",
            "--images_per_batch", 8, "--batch_size", 16,
            "--lstm_hidden_width", 6, "--hidden_width", 8, "--seed", 7]
    dirs = {}
    for tag in ("s", "m"):
        dirs[tag] = tmp_path / tag
        shutil.copytree(data, dirs[tag])
    _one("joint", base + ["--data_dir", dirs["s"]])
    outs = _ranks("joint", base + ["--data_dir", dirs["m"]])
    for out in outs:
        assert out.count("sharded predict") >= len(tasks), out
        assert out.count("distributed: reusing bootstrap") == 2, out
    for t in tasks:
        _assert_scores_equiv(dirs["m"] / f"train.{t}.scores",
                             dirs["s"] / f"train.{t}.scores")
    assert not list(dirs["m"].glob("*.part-*")), "part files not cleaned up"


def test_cli_four_process_predict_with_an_empty_slice(data, tmp_path):
    """Four ranks over three images: three interior boundaries, one slice
    empty, four parts merged in rank order (two ranks cannot tell a merge
    in rank order from a reversed one).  From the initial weights."""
    model = tmp_path / "m4"
    s1, s2 = tmp_path / "p4_s.scores", tmp_path / "p4_m.scores"
    table_s = _table(_one("relation",
                          _relation_predict(data, model, s1, "dev")))
    outs = _ranks("relation", _relation_predict(data, model, s2, "dev"),
                  world=4)
    slices = {}
    for out in outs:
        part = out.split("sharded predict: process ")[1]
        lo, hi = part.split("[")[1].split(")")[0].split(", ")
        slices[part[:3]] = (int(lo), int(hi))
    assert sorted(slices) == [f"{k}/4" for k in range(4)]
    cuts = [slices[f"{k}/4"] for k in range(4)]
    assert cuts[0][0] == 0 and cuts[-1][1] == 3
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    assert any(lo == hi for lo, hi in cuts)          # the empty slice
    _assert_scores_equiv(s2, s1)
    tables = [_table(out) for out in outs if "Accuracy:" in out]
    assert tables == [table_s]
    assert not list(tmp_path.glob("*.part-*"))
    assert not list(tmp_path.glob("*.sdpart-*"))
