"""The port's Keras oracle (``icl_torch/eval/oracle.py``) and
``--oracle-parity`` / ``--oracle-parity-full`` on the CPU.

The port's oracle functions are held to ``icl.eval.oracle``'s on the same
numpy inputs, to equal bits: the port takes the flat pinned-path params
(``caption_bilstm/fwd/kernel``), the original the nested tree.  Then each
task CLI trains a small model on a planted split and predicts it with
``--oracle-parity``: every run must print ``oracle-parity PASS`` under the
1e-5 gate, having compared two batches (every batch, or every mention, with
``-full``); an empty predict slice prints SKIPPED; and where ``keras``
cannot be imported the run is refused at start-up, before it reads any
data, with a message that names Keras and the flag.

Keras on the torch backend takes about 17 s to import, so every case that
imports it lives in this file.
"""

import contextlib
import io
import os
import re
import sys

import numpy as np
import pytest

import icl.eval.oracle as joracle
import icl_torch.eval.oracle as toracle
from icl_torch.cli import _common as tcommon
from icl_torch.cli import _mention_task
from icl_torch.cli import affinity as taffinity
from icl_torch.cli import cardinality as tcardinality
from icl_torch.cli import joint as tjoint
from icl_torch.cli import nonvisual as tnonvisual
from icl_torch.cli import relation as trelation
from icl_torch.params import init_params, to_numpy
from icl_torch.testing.synth import SynthConfig, generate_dataset

CLIS = {"relation": trelation, "affinity": taffinity,
        "nonvisual": tnonvisual, "cardinality": tcardinality}
WIDTHS = {"relation": ["--lstm_hidden_width", "8", "--head_hidden", "16"],
          "affinity": ["--lstm_hidden_width", "8", "--head_hidden", "16"],
          "nonvisual": ["--hidden_width", "16"],
          "cardinality": ["--hidden_width", "16"]}
ORACLE = {"relation": "oracle_relation", "affinity": "oracle_affinity",
          "nonvisual": "oracle_ffnn", "cardinality": "oracle_ffnn"}


def _nested(flat: dict) -> dict:
    """The JAX package's param tree for a flat pinned-path dict."""
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _params(task: str, dims: dict, seed: int) -> dict:
    flat = to_numpy(init_params(task, seed, dims))
    rng = np.random.default_rng(seed)
    # non-zero biases, so a bias dropped or misplaced shows
    return {k: (v + rng.normal(0, 0.1, v.shape).astype(np.float32)
                if k.endswith("bias") else v) for k, v in flat.items()}


def _equal(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_oracle_ffnn_and_bilstm_are_bit_equal():
    rng = np.random.default_rng(0)
    flat = _params("nonvisual", {"emb_dim": 12, "hidden": 10,
                                 "num_classes": 2}, seed=1)
    pooled = rng.normal(size=(9, 12)).astype(np.float32)
    _equal(toracle.oracle_ffnn(flat, pooled),
           joracle.oracle_ffnn(_nested(flat), pooled))
    flat = _params("relation", {"emb_dim": 6, "lstm_hidden": 5,
                                "head_hidden": 7}, seed=2)
    lstm = {k[len("caption_bilstm/"):]: v for k, v in flat.items()
            if k.startswith("caption_bilstm/")}
    x = rng.normal(size=(4, 7, 6)).astype(np.float32)
    lengths = np.array([7, 3, 1, 0])
    _equal(toracle.oracle_bilstm(lstm, x, lengths),
           joracle.oracle_bilstm(_nested(lstm), x, lengths))


def test_oracle_relation_is_bit_equal():
    rng = np.random.default_rng(3)
    flat = _params("relation", {"emb_dim": 6, "lstm_hidden": 5,
                                "head_hidden": 7}, seed=4)
    I, C, L, M, P = 2, 3, 6, 4, 5
    batch = {"tokens": rng.integers(0, 11, (I, C, L)).astype(np.int32),
             "tok_len": rng.integers(1, L + 1, (I, C)).astype(np.int32),
             "m_cap": rng.integers(0, C, (I, M)).astype(np.int32),
             "m_first": rng.integers(0, 3, (I, M)).astype(np.int32),
             "m_last": rng.integers(3, L, (I, M)).astype(np.int32),
             "pair_ij": rng.integers(0, M, (I, P, 2)).astype(np.int32)}
    table = rng.normal(size=(11, 6)).astype(np.float32)
    got = toracle.oracle_relation(flat, table, batch)
    _equal(got, joracle.oracle_relation(_nested(flat), table, batch))
    assert got.shape == (I, P, 4)


@pytest.mark.parametrize("phrase_enc", ["lstm", "mean_w2v"])
def test_oracle_affinity_is_bit_equal(phrase_enc):
    rng = np.random.default_rng(5)
    flat = _params("affinity", {"emb_dim": 6, "lstm_hidden": 5,
                                "head_hidden": 7, "box_dim": 9,
                                "phrase_enc": phrase_enc}, seed=6)
    I, M, L, B = 2, 3, 4, 5
    batch = {"phrase_tokens": rng.integers(0, 11, (I, M, L)).astype(np.int32),
             "phrase_len": rng.integers(0, L + 1, (I, M)).astype(np.int32),
             "box_feats": rng.normal(size=(I, B, 9)).astype(np.float32)}
    table = rng.normal(size=(11, 6)).astype(np.float32)
    got = toracle.oracle_affinity(flat, table, batch, phrase_enc=phrase_enc)
    _equal(got, joracle.oracle_affinity(_nested(flat), table, batch,
                                        phrase_enc=phrase_enc))
    assert got.shape == (I, M, B, 2)


def test_oracle_layers_run_on_the_cpu(monkeypatch):
    """Every layer is built and called under ``keras.device("cpu")``."""
    keras = toracle._k()
    seen = []
    real = keras.device

    def device(name):
        seen.append(name)
        return real(name)

    monkeypatch.setattr(keras, "device", device)
    rng = np.random.default_rng(7)
    toracle.keras_dense(rng.normal(size=(3, 2)).astype(np.float32), None,
                        rng.normal(size=(4, 3)).astype(np.float32))
    toracle.keras_lstm({"kernel": np.ones((3, 8), np.float32),
                        "recurrent_kernel": np.ones((2, 8), np.float32),
                        "bias": np.zeros(8, np.float32)},
                       np.ones((1, 2, 3), np.float32), np.array([2]))
    assert seen == ["cpu", "cpu"]


# ---------------------------------------------------------------------------
# --oracle-parity through the CLIs
# ---------------------------------------------------------------------------

def _stdout_of(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A planted split and a small model of each task trained on it."""
    d = str(tmp_path_factory.mktemp("torch_oracle"))
    generate_dataset(d, "train", SynthConfig(
        num_images=48, seed=3, planted=True, emb_dim=16, vocab_size=60,
        max_caption_len=16, max_mentions_per_caption=3,
        max_boxes_per_image=6))
    for task, cli in CLIS.items():
        batch = (["--images_per_batch", "16"] if task in ("relation",
                                                          "affinity")
                 else ["--batch_size", "64"])
        cli.main(["--train", "--data_dir", d, "--device", "cpu",
                  "--epochs", "2", *batch, *WIDTHS[task]])
    return d


def _predict(d, task, *extra):
    # the image tasks through the kernels' wrappers (their plain versions
    # on the CPU), as a predict on the card runs them
    batch = (["--images_per_batch", "16", "--fused", "on"]
             if task in ("relation", "affinity") else ["--batch_size", "64"])
    return _stdout_of(CLIS[task].main, [
        "--predict", "--data_dir", d, "--device", "cpu", *batch,
        "--scores_file", f"{d}/{task}.parity.scores", *extra])


def _verdict(out: str) -> tuple[str, float, str]:
    m = re.search(r"oracle-parity (PASS|FAIL): max_abs_diff=(\S+) "
                  r"gate=(\S+)", out)
    assert m, out
    return m.group(1), float(m.group(2)), m.group(3)


def _counting(monkeypatch, task):
    """Count the oracle's calls (image tasks: one a batch) and the rows it
    was given (mention tasks: the mentions compared)."""
    calls = []
    name = ORACLE[task]
    real = getattr(toracle, name)

    def oracle(params, *args, **kw):
        calls.append(len(args[0]) if name == "oracle_ffnn" else 1)
        return real(params, *args, **kw)

    monkeypatch.setattr(toracle, name, oracle)
    return calls


@pytest.mark.parametrize("full", [False, True], ids=["first", "full"])
@pytest.mark.parametrize("task", sorted(CLIS))
def test_oracle_parity_passes_on_the_cpu(trained, task, full, monkeypatch):
    calls = _counting(monkeypatch, task)
    predicts = []
    if task in ("relation", "affinity"):
        # the port's predict runs once a batch in the sweep, and again for
        # each batch the oracle compares
        name = f"{task}_predict"
        real = getattr(CLIS[task], name)
        monkeypatch.setattr(CLIS[task], name,
                            lambda *a, **kw: predicts.append(1) or real(*a,
                                                                        **kw))
    flag = "--oracle-parity-full" if full else "--oracle-parity"
    verdict, diff, gate = _verdict(_predict(trained, task, flag))
    assert verdict == "PASS" and diff <= 1e-5 and gate == "1e-05"
    assert os.path.exists(f"{trained}/{task}.parity.scores")
    if task in ("relation", "affinity"):
        swept = len(predicts) - len(calls)
        assert swept >= 3 and len(calls) == (swept if full else 2)
    else:
        n = len(open(f"{trained}/{task}.parity.scores").readlines())
        assert n > 256 and calls == [n if full else 256]


@pytest.mark.parametrize("task", sorted(CLIS))
def test_an_empty_predict_slice_prints_skipped(trained, task, monkeypatch):
    """A rank whose slice of the split is empty compares nothing and says
    so, rather than printing a PASS that verified nothing."""
    module = _mention_task if task in ("nonvisual", "cardinality") else \
        CLIS[task]
    monkeypatch.setattr(module, "begin_predict",
                        lambda rt, n, weights=None: (0, 0))
    out = _predict(trained, task, "--oracle-parity")
    assert "oracle-parity SKIPPED: empty predict slice" in out
    assert "PASS" not in out and "FAIL" not in out


@pytest.mark.parametrize("flag", ["--oracle-parity", "--oracle-parity-full"])
@pytest.mark.parametrize("cli", sorted(CLIS) + ["joint"])
def test_without_keras_the_flag_is_refused_at_start_up(cli, flag,
                                                       monkeypatch, tmp_path):
    """``import keras`` fails: the run stops before it reads any data (the
    data dir does not exist), naming Keras and the flag.  Without
    ``--predict`` the flags do nothing, as in the reference."""
    monkeypatch.setitem(sys.modules, "keras", None)
    monkeypatch.setattr(toracle, "_keras", None)
    main = tjoint.main if cli == "joint" else CLIS[cli].main
    argv = ["--data_dir", str(tmp_path / "absent"), "--device", "cpu", flag]
    with pytest.raises(tcommon.RefusedFlagError) as e:
        main(["--predict", *argv])
    assert e.value.flag == flag
    assert "Keras" in str(e.value) and flag in str(e.value)
    if cli != "joint":
        args = tcommon.parse_task_args(tcommon.base_parser(cli, ""),
                                       ["--train", *argv], cli)
        assert args.oracle_parity or args.oracle_parity_full
