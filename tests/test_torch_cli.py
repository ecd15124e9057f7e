"""icl-torch-relation / icl-torch-affinity against the JAX CLIs (CPU, f32).

The reference trains a tiny model with its own CLI (JAX on the CPU),
``icl-export`` writes the ``.npz``, and both packages' ``--predict`` score
the dev split from those weights: ids and order identical, every
probability within 1e-5 and within one unit of the sixth decimal as
printed.  Affinity also with ``--rank_file``: the port ranks through the
box-ranking kernel's wrapper (its plain version on the CPU), the reference
through ``rank_boxes``.  Two port predicts give identical bytes; ``--eval``
prints the reference's table.  Every flag of the reference's
``base_parser`` parses in the port's with the same default; each flag the
port cannot honour raises ``RefusedFlagError``.  ``--compute_dtype bf16``
runs end to end, as tests/integration/test_cli_e2e.py runs it in the
reference: train in bf16, predict from that checkpoint in f32 and in bf16,
with ``--rank_file``.
"""

import contextlib
import filecmp
import io
import json
import os

import numpy as np
import pytest
import torch

import icl.cli._common as jcommon
from icl.cli import affinity as jaffinity
from icl.cli import relation as jrelation
from icl.cli.export import export_checkpoint
from icl_torch.cli import _common as tcommon
from icl_torch.cli import affinity as taffinity
from icl_torch.cli import relation as trelation
from icl_torch.io.scores import read_scores
from icl_torch.models import rnn
from icl_torch.models.affinity import AffinityModel
from icl_torch.models.relation import RelationModel
from icl_torch.ops.lstm_recurrence import (lstm_recurrence,
                                           lstm_recurrence_reference)
from icl_torch.params import load_npz
from icl_torch.testing.synth import SynthConfig, generate_dataset
from icl_torch.train.checkpoint import Checkpointer

WIDTHS = ["--lstm_hidden_width", "16", "--head_hidden", "32"]
CLIS = {"relation": (jrelation, trelation), "affinity": (jaffinity, taffinity)}


def _stdout_of(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """task -> paths and tables of one reference train/export/predict and
    two port predicts from the exported weights."""
    d = str(tmp_path_factory.mktemp("torch_cli"))
    kw = dict(planted=True, emb_dim=16, vocab_size=40, max_caption_len=20,
              max_mentions_per_caption=3, max_boxes_per_image=6)
    generate_dataset(d, "train", SynthConfig(num_images=12, seed=1, **kw))
    generate_dataset(d, "dev", SynthConfig(num_images=8, seed=2, **kw))
    out = {"dir": d}
    for task, (jcli, tcli) in CLIS.items():
        jdir, tdir = f"{d}/{task}.jax", f"{d}/{task}.torch"
        os.makedirs(tdir)
        jcli.main(["--train", "--data_dir", d, "--epochs", "2", "--mesh", "1",
                   "--images_per_batch", "4", "--model_file", jdir, *WIDTHS])
        export_checkpoint(jdir, f"{tdir}/{task}.npz")
        r = {"jscores": f"{d}/{task}.jax.scores",
             "tscores": f"{d}/{task}.torch.scores",
             "tscores2": f"{d}/{task}.torch2.scores",
             "jrank": f"{d}/{task}.jax.rank", "trank": f"{d}/{task}.torch.rank",
             "tdir": tdir}
        rank = task == "affinity"
        common = ["--predict", "--data_dir", d, "--data_split", "dev",
                  "--images_per_batch", "4", "--eval"]
        r["jtable"] = _stdout_of(jcli.main, [
            *common, "--mesh", "1", "--model_file", jdir, "--scores_file",
            r["jscores"], *(["--rank_file", r["jrank"]] if rank else [])])
        # the port reads the widths from the archive's manifest
        port = [*common, "--device", "cpu", "--fused", "on", "--model_file",
                tdir]
        r["ttable"] = _stdout_of(tcli.main, [
            *port, "--scores_file", r["tscores"],
            *(["--rank_file", r["trank"]] if rank else [])])
        tcli.main([*port, "--scores_file", r["tscores2"]])
        out[task] = r
    return out


def _assert_scores_match(got_path, want_path):
    ids, got = read_scores(got_path)
    want_ids, want = read_scores(want_path)
    assert ids == want_ids and len(ids) > 50          # ids and their order
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5
    # as printed: at most one unit of the sixth decimal apart
    assert np.abs(np.rint(got * 1e6) - np.rint(want * 1e6)).max() <= 1


@pytest.mark.parametrize("task", sorted(CLIS))
def test_predict_scores_match_the_reference(runs, task):
    r = runs[task]
    _assert_scores_match(r["tscores"], r["jscores"])
    _, probs = read_scores(r["tscores"])
    assert np.abs(probs.sum(axis=1) - 1).max() <= 2e-6
    meta = json.load(open(r["tscores"] + ".meta.json"))
    want = json.load(open(r["jscores"] + ".meta.json"))
    for k in ("num_examples", "num_classes", "class_order", "task", "split",
              "checkpoint_step"):
        assert meta[k] == want[k], k


def test_rank_file_matches_the_reference(runs):
    r = runs["affinity"]
    _assert_scores_match(r["trank"], r["jrank"])
    ids, rank = read_scores(r["trank"])
    assert rank.shape[1] == 1
    by_mention = {}
    for cid, p in zip(ids, rank[:, 0]):
        by_mention.setdefault(cid.rsplit(";box:", 1)[0], []).append(p)
    sums = np.array([sum(v) for v in by_mention.values()])
    assert len(sums) > 10 and np.abs(sums - 1).max() <= 1e-5
    meta = json.load(open(r["trank"] + ".meta.json"))
    assert meta["task"] == "affinity_rank" and meta["class_order"] == [
        "rank_prob"]


@pytest.mark.parametrize("task", sorted(CLIS))
def test_two_port_predicts_give_identical_bytes(runs, task):
    r = runs[task]
    assert filecmp.cmp(r["tscores"], r["tscores2"], shallow=False)


@pytest.mark.parametrize("task", sorted(CLIS))
def test_eval_table_is_the_reference_table(runs, task):
    r = runs[task]
    assert r["ttable"] == r["jtable"]
    assert "Accuracy:" in r["ttable"] and " | " in r["ttable"]


@pytest.mark.parametrize("task", sorted(CLIS))
def test_train_starts_from_the_archive(runs, task, tmp_path):
    """``--train`` in a model dir that holds ``<task>.npz`` starts from its
    weights: with no epoch to run, the end marker holds exactly them."""
    tdir = str(tmp_path / "m")
    os.makedirs(tdir)
    for ext in ("", ".manifest.json"):
        os.link(f"{runs[task]['tdir']}/{task}.npz{ext}",
                f"{tdir}/{task}.npz{ext}")
    CLIS[task][1].main(["--train", "--data_dir", runs["dir"], "--epochs", "0",
                        "--device", "cpu", "--model_file", tdir, *WIDTHS])
    flat, _ = load_npz(f"{tdir}/{task}.npz")
    assert Checkpointer(tdir).all_steps() == [0]
    saved = torch.load(f"{tdir}/step_0.pt", weights_only=True)["model"]
    assert sorted(k.replace(".", "/") for k in saved) == sorted(flat)
    for k, v in saved.items():
        assert torch.equal(v, flat[k.replace(".", "/")]), k
    assert json.load(open(f"{tdir}/model_config.json"))["task"] == task
    assert json.load(open(f"{tdir}/train_config.json"))["_platform"] == "cpu"


class _Said:
    """Collects what the CLI module logs."""

    def __init__(self, monkeypatch):
        self.lines = []
        for level in ("info", "warning"):
            monkeypatch.setattr(tcommon.LOG, level, self._say)

    def _say(self, msg, *args):
        self.lines.append(msg % args if args else msg)

    def __contains__(self, text):
        return any(text in line for line in self.lines)


def test_predict_without_weights_warns_and_scores_from_init(runs, tmp_path,
                                                            monkeypatch):
    said = _Said(monkeypatch)
    trelation.main(["--predict", "--data_dir", runs["dir"], "--data_split",
                    "dev", "--device", "cpu", "--model_file",
                    str(tmp_path / "empty"), "--scores_file",
                    str(tmp_path / "s.scores"), *WIDTHS])
    assert "predicting from init" in said
    ids, probs = read_scores(str(tmp_path / "s.scores"))
    assert len(ids) > 50 and np.isfinite(probs).all()


def test_affinity_trains_and_predicts_with_either_phrase_encoder(runs,
                                                                tmp_path):
    """``--phrase_enc mean_w2v`` has no LSTM: the CLI builds and trains
    that model as well, and ``--predict`` reads the encoder back from the
    model dir."""
    model = str(tmp_path / "m")
    taffinity.main(["--train", "--data_dir", runs["dir"], "--device", "cpu",
                    "--phrase_enc", "mean_w2v", "--epochs", "1",
                    "--model_file", model, *WIDTHS])
    assert json.load(open(f"{model}/model_config.json"))[
        "phrase_enc"] == "mean_w2v"
    taffinity.main(["--predict", "--data_dir", runs["dir"], "--data_split",
                    "dev", "--device", "cpu", "--model_file", model,
                    "--scores_file", str(tmp_path / "s.scores"), *WIDTHS])
    ids, probs = read_scores(str(tmp_path / "s.scores"))
    assert len(ids) > 10 and np.isfinite(probs).all()


# --- the flag surface -------------------------------------------------------

REFERENCE_FLAGS = sorted(
    (a.option_strings[0], a.dest) for a in
    jcommon.base_parser("relation", "")._actions
    if a.option_strings and a.dest != "help")


@pytest.mark.parametrize("flag,dest", REFERENCE_FLAGS)
def test_every_reference_flag_parses_with_its_default(flag, dest):
    want = {a.dest: a for a in jcommon.base_parser("relation", "")._actions}
    got = {a.dest: a for a in tcommon.base_parser("relation", "")._actions}
    assert dest in got, flag
    a, b = got[dest], want[dest]
    assert a.option_strings == b.option_strings
    assert (a.default, a.type, a.choices, a.nargs, a.required,
            type(a)) == (b.default, b.type, b.choices, b.nargs, b.required,
                         type(b))


def test_the_port_adds_only_device():
    want = {a.dest for a in jcommon.base_parser("relation", "")._actions}
    got = {a.dest: a for a in tcommon.base_parser("relation", "")._actions}
    assert set(got) - want == {"device"} and got["device"].default == "cuda"


def _parse(extra, task="relation"):
    p = tcommon.base_parser(task, "")
    p.add_argument("--fused", default="auto", choices=["auto", "on", "off"])
    return tcommon.parse_task_args(
        p, ["--train", "--data_dir", "x", *extra], task)


@pytest.mark.parametrize("extra,dest,value", [
    (["--mesh", "8"], "mesh", "8"),
    (["--coordinator", "host:1234"], "coordinator", "host:1234"),
    (["--num_processes", "2"], "num_processes", 2),
    (["--process_id", "0"], "process_id", 0)])
def test_the_multi_process_flags_parse(extra, dest, value):
    """``torch.distributed`` is ported: the four flags are taken as given
    (``icl_torch.runtime.init`` reads them), no longer refused."""
    assert getattr(_parse(extra), dest) == value


@pytest.mark.parametrize("task", ["relation", "affinity", "nonvisual",
                                  "cardinality"])
def test_compute_dtype_bf16_is_taken(task):
    """``--compute_dtype bf16`` is ported: every task CLI takes it (the
    mention tasks log that it has no effect there)."""
    args = _parse(["--compute_dtype", "bf16"], task)
    assert args.compute_dtype == "bf16"
    assert tcommon.resolve_compute_dtype(args) is torch.bfloat16


@pytest.mark.parametrize("extra,flag", [
    (["--oracle-parity"], "--oracle-parity"),
    (["--oracle-parity-full"], "--oracle-parity-full"),
    (["--matmul_precision", "default"], "--matmul_precision"),
    (["--matmul_precision", "high"], "--matmul_precision")])
def test_unported_flag_values_are_refused_by_name(extra, flag):
    """Each of these flags was refused by name until its machinery was
    ported; now each is taken as given.  ``--matmul_precision default`` and
    ``high`` resolve on the device (tests/test_torch_precision.py); the
    oracle flags act only under ``--predict``, where Keras is imported at
    start-up (tests/test_torch_oracle.py), and do nothing in ``--train``,
    as in the reference."""
    args = _parse(extra)
    if flag == "--matmul_precision":
        assert args.matmul_precision == extra[1]
        prec = tcommon.precision_policy(args.matmul_precision, "cuda", False)
        assert prec.mode == extra[1] and not prec.head_exact
        return
    assert (args.oracle_parity, args.oracle_parity_full) == (
        flag == "--oracle-parity", flag == "--oracle-parity-full")


def test_harmless_values_of_those_flags_are_accepted(monkeypatch):
    said = _Said(monkeypatch)
    args = _parse(["--num_processes", "1", "--matmul_precision", "highest",
                   "--compute_dtype", "f32", "--compilation_cache_dir", "c",
                   "--hidden_width", "7", "--batch_size", "9",
                   "--profile_dir", "p"])
    assert args.num_processes == 1 and args.profile_dir == "p"
    assert "nothing to cache" in said and "--hidden_width 7" in said
    assert "--batch_size 9" in said


def test_config_file_sets_defaults_and_rejects_unknown_keys(tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({
        "task": "relation", "epochs": 3, "seed": 5,
        "buckets": {"caption_len": [8, 24]}, "_note": "x"}))
    args = _parse(["--config", str(cfg), "--seed", "6"])
    assert (args.epochs, args.seed) == (3, 6)        # the command line wins
    assert tcommon.bucket_spec(args, "caption_len", (16, 32)).boundaries == (8, 24)
    assert tcommon.bucket_spec(args, "other", (16, 32)).boundaries == (16, 32)
    cfg.write_text(json.dumps({"epocs": 3}))
    with pytest.raises(SystemExit):
        _parse(["--config", str(cfg)])
    cfg.write_text(json.dumps({"task": "affinity"}))
    with pytest.raises(SystemExit):
        _parse(["--config", str(cfg)])
    cfg.write_text(json.dumps({"hosts": {"num_processes": 4,
                                         "coordinator": "h:1"}}))
    args = _parse(["--config", str(cfg)])            # a multi-process config
    assert (args.num_processes, args.coordinator) == (4, "h:1")
    assert args.process_id is None                   # the launcher's to give
    with pytest.raises(SystemExit):                  # needs --eval_every
        _parse(["--early_stop", "2"])


@pytest.mark.parametrize("task", sorted(CLIS))
def test_the_default_device_is_the_card_and_raises_without_one(runs, task):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIS[task][1].main(["--predict", "--data_dir", runs["dir"]])


def test_fused_auto_and_the_lstm_width_check():
    """The recurrence kernel takes up to MAX_H = 512 units on CUDA; a wider
    LSTM with the kernel is refused when it is built, naming ``--fused
    off`` (there is no quiet plain-loop fallback on the card)."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for fused, dev, want in (("auto", cpu, False), ("auto", cuda, True),
                             ("on", cpu, True), ("off", cuda, False)):
        assert tcommon.use_fused(_parse(["--fused", fused]), dev) is want
    for hidden, use_kernel, dev in ((256, True, cuda), (300, True, cuda),
                                    (512, True, cuda), (600, True, cpu),
                                    (600, False, cuda)):
        rnn.check_lstm_width(hidden, use_kernel, dev)
    with pytest.raises(ValueError, match="--lstm_hidden_width 513.*512.*"
                                         "--fused off"):
        rnn.check_lstm_width(513, True, cuda)
    assert tcommon.parity_gate() == 1e-5
    assert tcommon.default_scores_path(_parse([]), "relation") == os.path.join(
        "x", "train.relation.scores")
    assert tcommon.default_model_dir(_parse([]), "affinity") == os.path.join(
        "x", "affinity.model")


@pytest.mark.parametrize("task", sorted(CLIS))
def test_a_wide_lstm_on_cuda_takes_the_recurrence_kernel_and_keeps_the_head(
        task):
    """A model built for the card at H = 300 (past the 8-block cluster's
    256 units, within the 16-block one's 512) runs the recurrence kernel
    and keeps ``fused`` for the grid-head kernels; at H = 513 building it
    is refused, naming ``--fused off``, and with ``fused`` off it takes the
    plain recurrence.  Fake tensors stand for the card's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    kw = dict(emb_dim=8, lstm_hidden=300, head_hidden=16, fused=True,
              device=torch.device("cuda"))

    def build(**over):
        with FakeTensorMode():
            return (RelationModel(**{**kw, **over}) if task == "relation"
                    else AffinityModel(box_dim=12, **{**kw, **over}))

    def lstm(model):
        return (model.caption_bilstm if task == "relation"
                else model.phrase_lstm)

    model = build()
    assert lstm(model).recurrence is lstm_recurrence
    assert model.fused and model.head_out.bias.device.type == "cuda"
    with pytest.raises(ValueError, match="--lstm_hidden_width 513.*"
                                         "--fused off"):
        build(lstm_hidden=513)
    assert lstm(build(lstm_hidden=513, fused=False)).recurrence is \
        lstm_recurrence_reference


def test_split_vocab_matches_the_reference(runs):
    for split in ("train", "dev"):
        assert tcommon.split_vocab(runs["dir"], split) == jcommon.split_vocab(
            runs["dir"], split)


# --- --compute_dtype bf16 end to end ---------------------------------------

@pytest.mark.parametrize("task", sorted(CLIS))
def test_bf16_trains_and_predicts_in_either_dtype(runs, task, tmp_path,
                                                  monkeypatch):
    """A bf16 run trains with f32 parameters, writes ``compute_dtype`` into
    ``model_config.json``, and its checkpoint predicts in f32 and in bf16
    (affinity with ``--rank_file``: each mention's row sums to 1, its ids
    those of the scores); the bf16 predict warns that its scores are not
    parity-grade and lands near the f32 one."""
    tcli = CLIS[task][1]
    md = str(tmp_path / "bf16.model")
    small = ["--data_dir", runs["dir"], "--device", "cpu", "--fused", "on",
             "--images_per_batch", "4", "--model_file", md, *WIDTHS]
    tcli.main(["--train", "--epochs", "1", "--compute_dtype", "bf16",
               *small])
    assert json.load(open(f"{md}/model_config.json"))["compute_dtype"] == \
        "bf16"
    saved = torch.load(f"{md}/step_{Checkpointer(md).latest_step}.pt",
                       weights_only=True)
    assert all(v.dtype == torch.float32 for v in saved["model"].values())
    said = _Said(monkeypatch)
    probs = {}
    for dtype in ("f32", "bf16"):
        sp = str(tmp_path / f"{dtype}.scores")
        rank = ["--rank_file", str(tmp_path / f"{dtype}.rank")] \
            if task == "affinity" else []
        tcli.main(["--predict", "--data_split", "dev", "--compute_dtype",
                   dtype, "--scores_file", sp, *rank, *small])
        ids, probs[dtype] = read_scores(sp)
        assert len(ids) > 50 and np.isfinite(probs[dtype]).all()
        assert np.abs(probs[dtype].sum(axis=1) - 1).max() <= 2e-6
        if rank:
            rids, r = read_scores(rank[1])
            assert rids == ids
            rows = {}
            for cid, p in zip(rids, r[:, 0]):
                rows.setdefault(cid.rsplit(";box:", 1)[0], []).append(p)
            assert max(abs(sum(v) - 1) for v in rows.values()) <= 1e-5
    assert "bf16 predict exceeds" in said
    assert 0 < np.abs(probs["bf16"] - probs["f32"]).max() <= 0.05
