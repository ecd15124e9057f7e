"""icl-torch-eval, icl-torch-check and icl-torch-baseline print what the
reference's ``icl-eval``, ``icl-check`` and ``icl-baseline`` print on the
same files, with the same exit codes (the cases follow
tests/integration/test_check_cli.py); every ``icl-torch-*`` script is
registered and answers ``--help``."""

import contextlib
import filecmp
import importlib
import io
import os
import re

import numpy as np
import pytest

from icl.cli import baseline as jbaseline
from icl.cli import check as jcheck
from icl.cli import evaluate as jevaluate
from icl_torch.cli import baseline as tbaseline
from icl_torch.cli import check as tcheck
from icl_torch.cli import evaluate as tevaluate
from icl_torch.io.boxes import read_box_feats, write_box_feats
from icl_torch.io.feats import read_feats_labels
from icl_torch.io.scores import write_scores
from icl_torch.testing.synth import SynthConfig, generate_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv):
    """(stdout, exit code or message) of one ``main(argv)``."""
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            main(argv)
        except SystemExit as e:
            code = e.code
    return buf.getvalue(), code


def _both(jmain, tmain, argv):
    """Run the reference's and the port's entry point; they must agree."""
    want, got = _run(jmain, argv), _run(tmain, argv)
    assert got == want
    return got


@pytest.fixture
def synth_dir(tmp_path):
    d = str(tmp_path)
    generate_dataset(d, "train", SynthConfig(num_images=3, seed=21))
    return d


# --- icl-torch-check --------------------------------------------------------

def _first_line(path):
    with open(path) as f:
        return next(line for line in f if "#" in line)


def _dangling_mention(d):
    with open(f"{d}/train.relation.feats", "a") as f:
        f.write("1 2:1 # doc:ghost.jpg;caption_1:0;mention_1:0"
                ";caption_2:0;mention_2:1\n")


def _missing_box(d):
    with open(f"{d}/train.affinity.feats", "a") as f:
        f.write("1 2:1 # doc:train_0000.jpg;caption:0;mention:0;box:999\n")


def _label_range_and_duplicate(d):
    first = _first_line(f"{d}/train.nonvisual.feats")
    with open(f"{d}/train.nonvisual.feats", "a") as f:
        f.write(first)                       # duplicate id -> warning
        f.write("7 " + first.partition(" ")[2])   # label 7 -> error


def _duplicate_only(d):
    first = _first_line(f"{d}/train.nonvisual.feats")
    with open(f"{d}/train.nonvisual.feats", "a") as f:
        f.write(first)


def _bad_grammar_and_clipped_span(d):
    with open(f"{d}/train.cardinality.feats", "a") as f:
        f.write("1 2:1 # not-an-id\n")
    with open(f"{d}/train.mentions.txt", "a") as f:
        f.write("doc:train_0000.jpg;caption:0;mention:99\t500,900\tx\n")


def _duplicate_box(d):
    path = f"{d}/train.boxes.npz"
    ids, feats = read_box_feats(path)
    write_box_feats(path, list(ids) + [ids[0]],
                    np.vstack([feats, feats[:1] + 1.0]))


def _non_ascii_and_odd_labels(d):
    first = _first_line(f"{d}/train.cardinality.feats")
    rest = first.partition(" ")[2]
    with open(f"{d}/train.cardinality.feats", "a", encoding="utf-8") as f:
        f.write("1.5 " + rest.replace("mention:", "mention:0", 1))
        f.write("nan " + rest.rstrip("\n") + " café\n")


def _no_captions(d):
    os.unlink(f"{d}/train.captions.txt")


CHECK_CASES = {
    # name: (corruption, extra argv, exit code, a phrase of the findings)
    "clean": (None, ["--strict"], 0, "0 error(s), 0 warning(s) — OK"),
    "dangling mention": (_dangling_mention, ["--task", "relation"], 1,
                         "reference a mention absent"),
    "missing box": (_missing_box, ["--task", "affinity"], 1, "box absent"),
    "label range, duplicate id": (_label_range_and_duplicate,
                                  ["--task", "nonvisual"], 1,
                                  "outside the 2-class"),
    "duplicate id passes": (_duplicate_only, ["--task", "nonvisual"], 0,
                            "duplicate example id"),
    "strict promotes warnings": (_duplicate_only,
                                 ["--task", "nonvisual", "--strict"], 1,
                                 "1 warning(s) — FAIL"),
    "bad grammar, clipped span": (_bad_grammar_and_clipped_span,
                                  ["--task", "cardinality"], 1,
                                  "violate the cardinality grammar"),
    "duplicate box warns": (_duplicate_box, ["--task", "affinity"], 0,
                            "LAST occurrence"),
    "duplicate box, strict": (_duplicate_box,
                              ["--task", "affinity", "--strict"], 1,
                              "duplicate box id"),
    "non-ascii, odd labels": (_non_ascii_and_odd_labels,
                              ["--task", "cardinality"], 1, "non-ASCII"),
    "no captions": (_no_captions, [], 1, "captions.txt: missing"),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_prints_the_reference_findings(synth_dir, case):
    corrupt, extra, code, phrase = CHECK_CASES[case]
    if corrupt:
        corrupt(synth_dir)
    out, got = _both(jcheck.main, tcheck.main,
                     ["--data_dir", synth_dir, *extra])
    assert got == code and phrase in out, out
    assert out.rstrip().splitlines()[-1].startswith("icl-check: ")


SCORES_CASES = {
    "clean": ("a,0.250000,0.750000\nb,0.500000,0.500000\n",
              ["--task", "nonvisual", "--strict"], None, 0,
              "0 error(s), 0 warning(s) — OK"),
    "bad rows": ("a,0.5,0.6\nb,0.40,0.612345\na,1.200000,-0.200000\n",
                 ["--task", "nonvisual"], None, 1, "outside [0, 1]"),
    "class count": ("a,0.300000,0.700000\n", ["--task", "relation"], None, 1,
                    "but relation has 4 classes"),
    "meta class order": ("a,0.300000,0.700000\n", ["--task", "nonvisual"],
                         '{"class_order": ["a", "b", "c"]}', 1,
                         "3 entries but the file has 2 columns"),
    "bad meta json": ("a,0.300000,0.700000\n", [], "{", 1, "bad json"),
    "ragged": ("a,0.3,x\n", [], None, 1, "error(s)"),
}


@pytest.mark.parametrize("case", sorted(SCORES_CASES))
def test_check_lints_a_scores_file_as_the_reference_does(tmp_path, case):
    text, extra, meta, code, phrase = SCORES_CASES[case]
    p = tmp_path / "x.scores"
    p.write_text(text)
    if meta is not None:
        (tmp_path / "x.scores.meta.json").write_text(meta)
    out, got = _both(jcheck.main, tcheck.main, ["--scores", str(p), *extra])
    assert got == code and phrase in out, out


def test_check_missing_scores_file_and_no_arguments(tmp_path, capsys):
    out, code = _both(jcheck.main, tcheck.main,
                      ["--scores", str(tmp_path / "none.scores")])
    assert code == 1 and "missing" in out
    assert _run(tcheck.main, [])[1] == 2          # argparse: one is required
    assert "--data_dir or --scores" in capsys.readouterr().err


# --- icl-torch-eval ---------------------------------------------------------

def _scores_for(d, task, tmp_path, seed=0, drop=0, dup=False):
    """Random probabilities for a split's gold ids, as a `.scores` file."""
    ids, _ = read_feats_labels(f"{d}/train.{task}.feats")
    ids = list(ids)[drop:]
    if dup:
        ids += ids[:3]
    C = tcheck.LABEL_CLASSES[task]
    probs = np.random.default_rng(seed).dirichlet(np.ones(C), size=len(ids))
    path = str(tmp_path / f"{task}.scores")
    write_scores(path, ids, probs)
    return path


@pytest.mark.parametrize("task", sorted(tcheck.LABEL_CLASSES))
def test_eval_prints_the_reference_table(synth_dir, tmp_path, task):
    scores = _scores_for(synth_dir, task, tmp_path)
    out, code = _both(jevaluate.main, tevaluate.main, [
        "--task", task, "--scores", scores, "--feats",
        f"{synth_dir}/train.{task}.feats"])
    assert code == 0 and "Accuracy:" in out and " | " in out
    assert tevaluate.TASK_CLASSES[task] == jevaluate.TASK_CLASSES[task]
    # the accuracy is the one the files give
    ids, gold = read_feats_labels(f"{synth_dir}/train.{task}.feats")
    from icl_torch.io.scores import read_scores
    _, probs = read_scores(scores)
    hits = int((probs.argmax(1) == gold.astype(int)).sum())
    assert f"({hits}/{len(ids)})" in out


@pytest.mark.parametrize("case,extra,code", [
    ("missing ids", [], 0), ("missing ids", ["--strict"], "id mismatch"),
    ("duplicates", [], 0), ("duplicates", ["--strict"], "duplicate ids"),
    ("wrong class count", [], "classes, expected"),
    ("no overlap", [], "no overlapping ids")])
def test_eval_id_hygiene_matches_the_reference(synth_dir, tmp_path, case,
                                               extra, code):
    task, feats_task = "nonvisual", "nonvisual"
    kw = {}
    if case == "missing ids":
        kw = {"drop": 4}
    elif case == "duplicates":
        kw = {"dup": True}
    elif case == "wrong class count":
        task = "relation"
    elif case == "no overlap":
        feats_task = "cardinality"
        with open(f"{synth_dir}/train.cardinality.feats", "w") as f:
            f.write("1 2:1 # doc:x.jpg;caption:0;mention:0\n")
    scores = _scores_for(synth_dir, "nonvisual", tmp_path, **kw)
    out, got = _both(jevaluate.main, tevaluate.main, [
        "--task", task, "--scores", scores, "--feats",
        f"{synth_dir}/train.{feats_task}.feats", *extra])
    if code == 0:
        assert got == 0 and "Accuracy:" in out
    else:
        assert code in str(got) and out == ""


@pytest.mark.parametrize("truncate", [False, True])
def test_eval_grounding_accuracy_matches_the_reference(synth_dir, tmp_path,
                                                       truncate):
    ids, gold = read_feats_labels(f"{synth_dir}/train.affinity.feats")
    ids = list(ids)
    rank = np.random.default_rng(3).random((len(ids), 1))
    rank[gold.astype(bool), 0] += 0.5          # mostly right
    if truncate:
        ids, rank = ids[:len(ids) // 2], rank[:len(ids) // 2]
    path = str(tmp_path / "train.affinity.rank")
    write_scores(path, ids, rank)
    argv = ["--task", "grounding", "--scores", path, "--feats",
            f"{synth_dir}/train.affinity.feats"]
    out, code = _both(jevaluate.main, tevaluate.main, argv)
    assert code == 0 and out.startswith("Top-1 grounding accuracy: ")
    if truncate:
        _, code = _both(jevaluate.main, tevaluate.main, [*argv, "--strict"])
        assert "never scored" in str(code)
    two = str(tmp_path / "two.scores")
    write_scores(two, ids, np.hstack([rank, rank]))
    _, code = _both(jevaluate.main, tevaluate.main,
                    ["--task", "grounding", "--scores", two, "--feats",
                     f"{synth_dir}/train.affinity.feats"])
    assert "1 column" in str(code)


# --- icl-torch-baseline -----------------------------------------------------

@pytest.mark.parametrize("task", ["nonvisual", "relation"])
def test_baseline_matches_the_reference(tmp_path, task):
    pytest.importorskip("sklearn")
    dirs = []
    for name in ("jax", "torch"):
        d = str(tmp_path / name)
        generate_dataset(d, "train", SynthConfig(num_images=6, seed=5))
        generate_dataset(d, "dev", SynthConfig(num_images=3, seed=6))
        dirs.append(d)
    outs = []
    for main, d in zip((jbaseline.main, tbaseline.main), dirs):
        assert _run(main, ["--task", task, "--train", "--data_dir", d,
                           "--max_iter", "50"]) == ("", 0)
        outs.append(_run(main, ["--task", task, "--predict", "--data_dir", d,
                                "--data_split", "dev", "--eval"]))
    assert outs[0] == outs[1] and "Accuracy:" in outs[0][0]
    name = f"dev.{task}.logistic.scores"
    assert filecmp.cmp(f"{dirs[0]}/{name}", f"{dirs[1]}/{name}",
                       shallow=False)
    assert tbaseline.TASK_CLASSES == jbaseline.TASK_CLASSES


# --- the scripts ------------------------------------------------------------

SCRIPTS = {
    "icl-torch-serve": "icl_torch.serve:main",
    "icl-torch-relation": "icl_torch.cli.relation:main",
    "icl-torch-affinity": "icl_torch.cli.affinity:main",
    "icl-torch-nonvisual": "icl_torch.cli.nonvisual:main",
    "icl-torch-cardinality": "icl_torch.cli.cardinality:main",
    "icl-torch-joint": "icl_torch.cli.joint:main",
    "icl-torch-eval": "icl_torch.cli.evaluate:main",
    "icl-torch-check": "icl_torch.cli.check:main",
    "icl-torch-baseline": "icl_torch.cli.baseline:main",
    "icl-torch-export": "icl_torch.cli.export:main",
    "icl-torch-import": "icl_torch.cli.import_:main",
}


def _registered() -> dict:
    text = open(os.path.join(REPO, "pyproject.toml"), encoding="utf-8").read()
    return dict(re.findall(r'^(icl-torch-[\w-]+) = "([\w.:]+)"$', text, re.M))


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_every_script_is_registered_and_answers_help(script, capsys):
    assert _registered().get(script) == SCRIPTS[script]
    module, fn = SCRIPTS[script].split(":")
    main = getattr(importlib.import_module(module), fn)
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    assert script in capsys.readouterr().out.split("\n", 1)[0]


def test_the_port_registers_one_script_per_reference_script():
    text = open(os.path.join(REPO, "pyproject.toml"), encoding="utf-8").read()
    reference = set(re.findall(r'^icl-([\w-]+) = "icl\.', text, re.M))
    port = {s[len("icl-torch-"):] for s in _registered()}
    assert port == reference == {s[len("icl-torch-"):] for s in SCRIPTS}
