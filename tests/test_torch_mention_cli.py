"""icl-torch-nonvisual / -cardinality / -joint against the JAX CLIs (CPU,
f32).

The reference trains a tiny model of each of the four tasks with its own
CLIs (JAX on the CPU) in one data dir; ``icl-export`` writes each ``.npz``
into the model dirs of a copy of that data dir; ``icl-joint`` scores the
dev split there and ``icl-torch-joint`` here.  Every file: ids and order
identical, every probability within 1e-5 and within one unit of the sixth
decimal as printed; ``--eval`` prints the reference's tables.  The port's
own task CLIs write the bytes its joint run wrote.  A mention run cut short
and resumed ends bit-identical to the uninterrupted one.
"""

import contextlib
import filecmp
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from icl.cli import affinity as jaffinity
from icl.cli import cardinality as jcardinality
from icl.cli import joint as jjoint
from icl.cli import nonvisual as jnonvisual
from icl.cli import relation as jrelation
from icl.cli.export import export_checkpoint
from icl_torch.cli import _common as tcommon
from icl_torch.cli import cardinality as tcardinality
from icl_torch.cli import joint as tjoint
from icl_torch.cli import nonvisual as tnonvisual
from icl_torch.io.scores import read_scores
from icl_torch.testing.synth import SynthConfig, generate_dataset

MENTION = {"nonvisual": (jnonvisual, tnonvisual, 2),
           "cardinality": (jcardinality, tcardinality, 12)}
TASKS = ("nonvisual", "relation", "affinity", "cardinality")
FILES = [f"dev.{t}.scores" for t in TASKS] + ["dev.affinity.rank"]


def _stdout_of(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's data dir (four trained tasks, its joint run) and the
    port's copy of it (exported weights, the port's joint run)."""
    root = tmp_path_factory.mktemp("torch_mention_cli")
    jd, td = str(root / "jax"), str(root / "torch")
    kw = dict(planted=True, emb_dim=16, vocab_size=40, max_caption_len=12,
              max_mentions_per_caption=3, max_boxes_per_image=4)
    generate_dataset(jd, "train", SynthConfig(num_images=24, seed=1, **kw))
    generate_dataset(jd, "dev", SynthConfig(num_images=10, seed=2, **kw))
    shutil.copytree(jd, td)
    common = ["--train", "--data_dir", jd, "--mesh", "1"]
    for cli in (jnonvisual, jcardinality):
        cli.main([*common, "--epochs", "4", "--hidden_width", "32",
                  "--batch_size", "64"])
    for cli in (jrelation, jaffinity):
        cli.main([*common, "--epochs", "1", "--images_per_batch", "8",
                  "--lstm_hidden_width", "8", "--head_hidden", "16"])
    for task in TASKS:
        os.makedirs(f"{td}/{task}.model")
        export_checkpoint(f"{jd}/{task}.model",
                          f"{td}/{task}.model/{task}.npz")
    shared = ["--predict", "--data_split", "dev", "--batch_size", "64",
              "--images_per_batch", "4", "--eval", "--with_cardinality",
              "--with_rank"]
    jtables = _stdout_of(jjoint.main, [*shared, "--data_dir", jd, "--mesh",
                                       "1"])
    ttables = _stdout_of(tjoint.main, [*shared, "--data_dir", td, "--device",
                                       "cpu", "--fused", "on"])
    return {"jd": jd, "td": td, "jtables": jtables, "ttables": ttables}


@pytest.mark.parametrize("name", FILES)
def test_joint_files_match_the_reference(runs, name):
    ids, got = read_scores(f"{runs['td']}/{name}")
    want_ids, want = read_scores(f"{runs['jd']}/{name}")
    assert ids == want_ids and len(ids) > 50          # ids and their order
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
    # as printed: at most one unit of the sixth decimal apart
    assert np.abs(np.rint(got * 1e6) - np.rint(want * 1e6)).max() <= 1
    meta = json.load(open(f"{runs['td']}/{name}.meta.json"))
    ref = json.load(open(f"{runs['jd']}/{name}.meta.json"))
    for k in ("num_examples", "num_classes", "class_order", "task", "split"):
        assert meta[k] == ref[k], k


def test_joint_prints_the_reference_tables(runs):
    assert runs["ttables"] == runs["jtables"]
    assert runs["ttables"].count("Accuracy:") == 4
    assert "11+ " in runs["ttables"] and "nonvisual " in runs["ttables"]


@pytest.mark.parametrize("task", sorted(MENTION))
def test_the_task_cli_writes_what_joint_wrote(runs, task, tmp_path):
    """``icl-torch-<task> --predict --eval`` alone: the joint run's bytes,
    the reference's table, ids in dataset (``.feats``) order."""
    jcli, tcli, C = MENTION[task]
    argv = ["--predict", "--data_dir", runs["td"], "--data_split", "dev",
            "--batch_size", "64", "--device", "cpu", "--eval"]
    outs = [str(tmp_path / f"{k}.scores") for k in (1, 2)]
    table = _stdout_of(tcli.main, [*argv, "--scores_file", outs[0]])
    tcli.main([*argv, "--scores_file", outs[1], "--batch_size", "16"])
    assert filecmp.cmp(outs[0], f"{runs['td']}/dev.{task}.scores",
                       shallow=False)
    # another batch size: other batches, the same rows in the same order
    ids, probs = read_scores(outs[0])
    ids2, probs2 = read_scores(outs[1])
    assert ids == ids2 and np.abs(probs - probs2).max() <= 1e-6
    want = _stdout_of(jcli.main, [
        "--predict", "--data_dir", runs["jd"], "--data_split", "dev",
        "--batch_size", "64", "--mesh", "1", "--eval", "--scores_file",
        str(tmp_path / "j.scores")])
    assert table == want and "Accuracy:" in table
    from icl_torch.io.feats import read_feats_labels
    gold_ids, _ = read_feats_labels(f"{runs['td']}/dev.{task}.feats")
    assert ids == list(gold_ids) and probs.shape == (len(ids), C)
    # six decimals a class: a row's sum is off by at most half a unit each
    assert np.abs(probs.sum(axis=1) - 1).max() <= C * 0.5e-6 + 1e-9
    meta = json.load(open(outs[0] + ".meta.json"))
    assert (meta["task"], meta["split"]) == (task, "dev")
    assert meta["checkpoint_step"] == json.load(open(
        f"{runs['td']}/{task}.model/{task}.npz.manifest.json"))["step"]


def _end_state(model_dir):
    steps = sorted(int(n[5:-3]) for n in os.listdir(model_dir)
                   if n.startswith("step_"))
    return steps, torch.load(f"{model_dir}/step_{steps[-1]}.pt",
                             weights_only=True)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("task", sorted(MENTION))
def test_train_writes_a_model_dir_and_resume_is_bit_identical(runs, task,
                                                              tmp_path):
    """A run stopped after 3 of 6 epochs whose end marker is deleted resumes
    from a periodic checkpoint (mid-epoch, shuffling and dropout 0.5 on)
    and ends with the uninterrupted run's weights and Adam state bit for
    bit."""
    _, tcli, C = MENTION[task]
    whole, cut = str(tmp_path / "whole"), str(tmp_path / "cut")
    train = ["--train", "--data_dir", runs["td"], "--device", "cpu",
             "--hidden_width", "24", "--batch_size", "32", "--ckpt_every",
             "5", "--eval_every", "4", "--seed", "7"]
    tcli.main([*train, "--epochs", "6", "--model_file", whole,
               "--metrics_file", str(tmp_path / "m.jsonl")])
    tcli.main([*train, "--epochs", "3", "--model_file", cut])
    steps, _ = _end_state(cut)
    os.unlink(f"{cut}/step_{steps[-1]}.pt")            # the end marker
    assert steps[-2] % 5 == 0
    tcli.main([*train, "--epochs", "6", "--resume", "auto", "--model_file",
               cut])
    (wsteps, a), (csteps, b) = _end_state(whole), _end_state(cut)
    assert wsteps[-1] == csteps[-1] and a["step"] == b["step"] > steps[-2]
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k, v in fa.items():
        same = torch.equal(v, fb[k]) if isinstance(v, torch.Tensor) \
            else v == fb[k]
        assert same, k
    # the model dir: configs as the reference writes them, no table inside
    cfg = json.load(open(f"{whole}/model_config.json"))
    assert cfg == {"task": task, "hidden": 24, "num_classes": C,
                   "dropout": 0.5}
    tc = json.load(open(f"{whole}/train_config.json"))
    assert tc["_platform"] == "cpu" and tc["batch_size"] == 32
    assert sorted(a["model"]) == ["dense_1.bias", "dense_1.kernel",
                                  "dense_out.bias", "dense_out.kernel"]
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    evals = [r for r in rows if "eval_loss" in r]
    assert evals and all(np.isfinite(r["eval_loss"]) for r in evals)
    assert any("loss" in r and r["examples_per_sec"] > 0 for r in rows)


def test_eval_batches_0_evaluates_the_whole_split(runs, tmp_path):
    """``--eval_batches 0`` (the whole split, copied per eval) and a cap
    that covers the split give the same dev losses."""
    logs = []
    for k, n in enumerate(("0", "99")):
        m = str(tmp_path / f"m{k}.jsonl")
        tnonvisual.main(["--train", "--data_dir", runs["td"], "--device",
                         "cpu", "--hidden_width", "8", "--batch_size", "32",
                         "--epochs", "2", "--eval_every", "3",
                         "--eval_batches", n, "--model_file",
                         str(tmp_path / f"d{k}"), "--metrics_file", m])
        logs.append([json.loads(line) for line in open(m)])
    evals = [[(r["step"], r["eval_loss"], r["eval_acc"]) for r in rows
              if "eval_loss" in r] for rows in logs]
    assert evals[0] == evals[1] and len(evals[0]) >= 2


# --- the flag surface -------------------------------------------------------

class _Said:
    def __init__(self, monkeypatch):
        self.lines = []
        for level in ("info", "warning"):
            monkeypatch.setattr(tcommon.LOG, level, self._say)

    def _say(self, msg, *args):
        self.lines.append(msg % args if args else msg)

    def __contains__(self, text):
        return any(text in line for line in self.lines)


@pytest.mark.parametrize("task", sorted(MENTION))
def test_hidden_width_and_batch_size_are_the_mention_tasks_flags(
        task, monkeypatch):
    said = _Said(monkeypatch)
    args = tcommon.parse_task_args(
        tcommon.base_parser(task, ""),
        ["--train", "--data_dir", "x", "--hidden_width", "7", "--batch_size",
         "9"], task)
    assert (args.hidden_width, args.batch_size) == (7, 9)
    assert "unused" not in said
    assert tcommon.parse_task_args(tcommon.base_parser(task, ""), [
        "--train", "--data_dir", "x", "--mesh", "2"], task).mesh == "2"


@pytest.mark.parametrize("extra", [
    ["--config", "c.json"], ["--model_file", "m"], ["--scores_file", "s"],
    ["--metrics_file", "m.jsonl"], ["--profile_dir", "p"]])
def test_joint_hard_errors_on_flags_it_cannot_mean(extra, capsys):
    with pytest.raises(SystemExit):
        tjoint.main(["--predict", "--data_dir", "x", *extra])
    assert f"{extra[0]} is not supported by icl-torch-joint" in \
        capsys.readouterr().err


def test_joint_is_inference_only(capsys):
    with pytest.raises(SystemExit):
        tjoint.main(["--train", "--data_dir", "x"])
    assert "inference-only" in capsys.readouterr().err


@pytest.mark.parametrize("extra", [
    ["--mesh", "8"], ["--coordinator", "host:1234"],
    ["--num_processes", "2"], ["--process_id", "0"]])
def test_joint_forwards_the_multi_process_flags(extra, monkeypatch):
    """Each sub-run gets the bootstrap flags as given: dropping one would
    leave every process sweeping the whole split."""
    seen = []
    for mod in (tjoint.nv_cli, tjoint.rel_cli, tjoint.aff_cli,
                tjoint.card_cli):
        monkeypatch.setattr(mod, "main", seen.append)
    tjoint.main(["--predict", "--data_dir", "x", "--with_cardinality",
                 *extra])
    assert len(seen) == 4
    for argv in seen:
        assert argv[argv.index(extra[0]) + 1] == extra[1]


def test_joint_forwards_compute_dtype_bf16(monkeypatch):
    """``--compute_dtype bf16`` is ported: joint takes it and passes it to
    every sub-run."""
    seen = []
    for mod in (tjoint.nv_cli, tjoint.rel_cli, tjoint.aff_cli,
                tjoint.card_cli):
        monkeypatch.setattr(mod, "main", seen.append)
    tjoint.main(["--predict", "--data_dir", "x", "--with_cardinality",
                 "--compute_dtype", "bf16"])
    assert len(seen) == 4
    assert all(argv[argv.index("--compute_dtype") + 1] == "bf16"
               for argv in seen)


def test_joint_runs_in_bf16_and_the_mention_tasks_ignore_it(runs, tmp_path):
    """``icl-torch-joint --compute_dtype bf16`` over the port's data dir:
    the mention tasks' ``.scores`` are the f32 run's bytes (bf16 has no
    effect on them, as in the reference), relation and affinity score
    every id of the f32 run, within the bf16 drift."""
    td = str(tmp_path / "bf16")
    shutil.copytree(runs["td"], td)
    for name in FILES:
        os.unlink(f"{td}/{name}")
    tjoint.main(["--predict", "--data_dir", td, "--data_split", "dev",
                 "--batch_size", "64", "--images_per_batch", "4",
                 "--device", "cpu", "--fused", "on", "--with_cardinality",
                 "--with_rank", "--compute_dtype", "bf16"])
    for name in FILES:
        got, want = f"{td}/{name}", f"{runs['td']}/{name}"
        if name.split(".")[1] in MENTION:
            assert filecmp.cmp(got, want, shallow=False), name
            continue
        ids, p = read_scores(got)
        want_ids, q = read_scores(want)
        assert ids == want_ids and np.abs(p - q).max() <= 0.05, name


@pytest.mark.parametrize("extra,flag", [
    (["--oracle-parity"], "--oracle-parity"),
    (["--matmul_precision", "default"], "--matmul_precision")])
def test_joint_refuses_the_unported_flags_before_any_sub_run(extra, flag,
                                                            monkeypatch):
    """Both flags were refused before any sub-run started until they were
    ported; now each goes to every sub-run, as the reference's joint passes
    them on (icl/cli/joint.py).  The oracle's Keras is checked at the
    joint's start-up (a stand-in here: the real import, and its refusal
    where Keras is absent, are tests/test_torch_oracle.py's)."""
    from icl_torch.eval import oracle

    imported = []
    monkeypatch.setattr(oracle, "_k", lambda: imported.append(1))
    seen = []
    for mod in (tjoint.nv_cli, tjoint.rel_cli, tjoint.aff_cli,
                tjoint.card_cli):
        monkeypatch.setattr(mod, "main", seen.append)
    tjoint.main(["--predict", "--data_dir", "/nonexistent",
                 "--with_cardinality", *extra])
    assert len(seen) == 4
    assert all(argv[argv.index(flag):argv.index(flag) + len(extra)] == extra
               for argv in seen)
    assert len(imported) == (flag == "--oracle-parity")


@pytest.mark.parametrize("cli", [tnonvisual, tcardinality, tjoint])
def test_the_default_device_is_the_card_and_raises_without_one(runs, cli):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--predict", "--data_dir", runs["td"]])
