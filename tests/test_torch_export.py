"""icl-torch-export / icl-torch-import, and archives crossing between the
two packages both ways (CPU, f32).

* JAX train -> ``icl-export`` -> ``icl-torch-import`` -> port predict
  matches JAX predict;
* port train -> ``icl-torch-export`` -> ``icl-import`` -> JAX predict
  matches port predict;
* port export -> port import -> predict: byte-identical ``.scores``, every
  exported leaf byte-identical to the checkpoint's;
* ``--validate_only``, the occupied-dir guard, and the five faults of the
  reference's import that the port's must not repeat, each as a case.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from icl.cli import nonvisual as jnonvisual
from icl.cli import relation as jrelation
from icl.cli.export import export_checkpoint as jax_export
from icl.cli.import_ import import_checkpoint as jax_import
from icl_torch.cli import export as texport
from icl_torch.cli import import_ as timport
from icl_torch.cli import nonvisual as tnonvisual
from icl_torch.cli import relation as trelation
from icl_torch.io.scores import read_scores
from icl_torch.params import init_params, load_npz, save_npz
from icl_torch.testing.synth import SynthConfig, generate_dataset
from icl_torch.train.checkpoint import Checkpointer

CLIS = {"nonvisual": (jnonvisual, tnonvisual,
                      ["--hidden_width", "24", "--batch_size", "32"]),
        "relation": (jrelation, trelation,
                     ["--lstm_hidden_width", "8", "--head_hidden", "16",
                      "--images_per_batch", "4"])}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_export"))
    kw = dict(planted=True, emb_dim=16, vocab_size=40, max_caption_len=12,
              max_mentions_per_caption=3, max_boxes_per_image=4)
    generate_dataset(d, "train", SynthConfig(num_images=16, seed=1, **kw))
    generate_dataset(d, "dev", SynthConfig(num_images=8, seed=2, **kw))
    return d


@pytest.fixture(scope="module")
def port_runs(data):
    """task -> a model dir the port's ``--train`` wrote, its export, and
    the port's predict from the model dir."""
    out = {}
    for task, (_, tcli, widths) in CLIS.items():
        m = f"{data}/{task}.port"
        tcli.main(["--train", "--data_dir", data, "--device", "cpu",
                   "--epochs", "2", "--ckpt_every", "3", "--model_file", m,
                   *widths])
        npz = f"{data}/{task}.port.npz"
        manifest = texport.export_checkpoint(m, npz)
        scores = f"{data}/{task}.port.scores"
        tcli.main(_predict(data, m, scores, widths) + ["--device", "cpu"])
        out[task] = {"dir": m, "npz": npz, "manifest": manifest,
                     "scores": scores}
    return out


def _predict(data, model_dir, scores, widths):
    return ["--predict", "--data_dir", data, "--data_split", "dev",
            "--model_file", model_dir, "--scores_file", scores,
            *_sized(widths)]


def _sized(widths):
    """The batching flags of ``widths`` (the model's widths come from the
    model dir's config on predict)."""
    pairs = list(zip(widths[::2], widths[1::2]))
    return [x for k, v in pairs if k in ("--batch_size", "--images_per_batch")
            for x in (k, v)]


def _assert_scores_match(got_path, want_path):
    ids, got = read_scores(got_path)
    want_ids, want = read_scores(want_path)
    assert ids == want_ids and len(ids) > 50
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(np.rint(got * 1e6) - np.rint(want * 1e6)).max() <= 1


@pytest.mark.parametrize("task", sorted(CLIS))
def test_jax_export_imports_into_the_port(data, task, tmp_path):
    jcli, tcli, widths = CLIS[task]
    jdir = str(tmp_path / "jax.model")
    jcli.main(["--train", "--data_dir", data, "--mesh", "1", "--epochs", "2",
               "--model_file", jdir, *widths])
    jscores = str(tmp_path / "jax.scores")
    jcli.main(_predict(data, jdir, jscores, widths) + ["--mesh", "1"])
    npz = str(tmp_path / "w.npz")
    manifest = jax_export(jdir, npz)
    imported = str(tmp_path / "imported")
    timport.main(["--npz", npz, "--model_file", imported, "--seed", "9"])
    tscores = str(tmp_path / "port.scores")
    tcli.main(_predict(data, imported, tscores, widths) + ["--device", "cpu"])
    _assert_scores_match(tscores, jscores)
    # the model dir is a trained one's: the step, the seed, the configs
    assert Checkpointer(imported).all_steps() == [manifest["step"]]
    payload = torch.load(f"{imported}/step_{manifest['step']}.pt",
                         weights_only=True)
    assert (payload["seed"], payload["epoch"]) == (9, 0)
    assert payload["optimizer"]["state"] == {}             # fresh Adam
    assert json.load(open(f"{imported}/model_config.json")) == \
        manifest["model_config"]
    assert json.load(open(f"{imported}/train_config.json")) == \
        manifest["train_config"]
    meta = json.load(open(tscores + ".meta.json"))
    assert meta["checkpoint_step"] == manifest["step"]


@pytest.mark.parametrize("task", sorted(CLIS))
def test_port_export_imports_into_jax(data, port_runs, task, tmp_path):
    jcli, _, widths = CLIS[task]
    r = port_runs[task]
    # the port's train_config carries its own flags; the reference's import
    # takes the archive all the same
    assert {"device", "_platform"} <= set(r["manifest"]["train_config"])
    jdir = str(tmp_path / "jax_imported")
    assert jax_import(r["npz"], jdir) == r["manifest"]["step"]
    jscores = str(tmp_path / "jax.scores")
    jcli.main(_predict(data, jdir, jscores, widths) + ["--mesh", "1"])
    _assert_scores_match(r["scores"], jscores)


@pytest.mark.parametrize("task", sorted(CLIS))
def test_export_is_byte_identical_and_round_trips(data, port_runs, task,
                                                  tmp_path):
    _, tcli, widths = CLIS[task]
    r = port_runs[task]
    steps = Checkpointer(r["dir"]).all_steps()
    assert r["manifest"]["step"] == steps[-1]
    saved = torch.load(f"{r['dir']}/step_{steps[-1]}.pt",
                       weights_only=True)["model"]
    with np.load(r["npz"]) as z:
        assert z.files == sorted(k.replace(".", "/") for k in saved)
        for k, v in saved.items():
            leaf = z[k.replace(".", "/")]
            assert leaf.dtype == np.float32 and leaf.shape == tuple(v.shape)
            assert leaf.tobytes() == v.numpy().tobytes(), k
    man = json.load(open(r["npz"] + ".manifest.json"))
    assert man == r["manifest"]
    assert set(man) == {"step", "params", "total_parameters", "model_config",
                        "train_config"}
    assert man["total_parameters"] == sum(v.numel() for v in saved.values())
    assert man["model_config"]["task"] == task
    flat, _ = load_npz(r["npz"])                     # shapes, dtypes agree

    imported = str(tmp_path / "imported")
    timport.main(["--npz", r["npz"], "--model_file", imported])
    again = str(tmp_path / "again.scores")
    tcli.main(_predict(data, imported, again, widths) + ["--device", "cpu"])
    assert filecmp.cmp(again, r["scores"], shallow=False)
    back = torch.load(f"{imported}/step_{steps[-1]}.pt",
                      weights_only=True)["model"]
    assert all(torch.equal(back[k], saved[k]) for k in saved)


def test_export_a_named_step_and_a_missing_one(port_runs, tmp_path):
    r = port_runs["nonvisual"]
    steps = Checkpointer(r["dir"]).all_steps()
    assert len(steps) >= 2
    out = str(tmp_path / "early.npz")
    texport.main(["--model_file", r["dir"], "--out", out, "--step",
                  str(steps[0])])
    assert json.load(open(out + ".manifest.json"))["step"] == steps[0]
    with np.load(out) as a, np.load(r["npz"]) as b:
        assert any(a[k].tobytes() != b[k].tobytes() for k in a.files)
    with pytest.raises(ValueError) as e:
        texport.export_checkpoint(r["dir"], out, step=12345)
    assert str(steps) in str(e.value)                # the steps there are
    with pytest.raises(FileNotFoundError):
        texport.export_checkpoint(str(tmp_path / "nothing"), out)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        texport.export_checkpoint(str(tmp_path / "empty"), out)


def test_an_imported_dir_resumes_training_with_a_fresh_adam(data, port_runs,
                                                            tmp_path):
    r = port_runs["nonvisual"]
    imported = str(tmp_path / "imported")
    timport.main(["--npz", r["npz"], "--model_file", imported, "--seed", "5"])
    tnonvisual.main(["--train", "--data_dir", data, "--device", "cpu",
                     "--epochs", "1", "--resume", "auto", "--model_file",
                     imported, "--hidden_width", "24", "--batch_size", "32"])
    steps = Checkpointer(imported).all_steps()
    assert steps[0] == r["manifest"]["step"] and steps[-1] > steps[0]
    end = torch.load(f"{imported}/step_{steps[-1]}.pt", weights_only=True)
    assert end["seed"] == 5 and end["optimizer"]["state"]   # moments now


# --- checks; the reference's five faults, each a case that passes here ------

class _Said:
    def __init__(self, monkeypatch):
        self.lines = []
        for level in ("info", "warning"):
            monkeypatch.setattr(timport.LOG, level, self._say)

    def _say(self, msg, *args):
        self.lines.append(msg % args if args else msg)

    def __contains__(self, text):
        return any(text in line for line in self.lines)


def _archive(tmp_path, task="nonvisual", manifest=True, **dims):
    dims = dims or {"emb_dim": 16, "hidden": 8}
    path = str(tmp_path / f"{task}.npz")
    save_npz(path, init_params(task, 0, dims), {"task": task, **dims}, step=7)
    if not manifest:
        os.unlink(path + ".manifest.json")
    return path


def test_fault_1_import_takes_a_seed(tmp_path):
    npz = _archive(tmp_path)
    timport.main(["--npz", npz, "--model_file", str(tmp_path / "a"),
                  "--seed", "11"])
    timport.main(["--npz", npz, "--model_file", str(tmp_path / "b")])
    seeds = [torch.load(f"{tmp_path}/{d}/step_7.pt", weights_only=True)[
        "seed"] for d in "ab"]
    assert seeds == [11, 0]


def test_fault_2_validate_only_without_a_manifest_says_what_it_checked(
        tmp_path, monkeypatch):
    said = _Said(monkeypatch)
    npz = _archive(tmp_path, manifest=False)
    assert timport.import_checkpoint(npz, None, validate_only=True) == 0
    assert "structure only" in said and "NO manifest" in said
    # the leaves identify the task, so the keys are held against its model
    assert "held against the nonvisual model's" in said
    with np.load(npz) as z:
        flat = {k: z[k] for k in z.files}
    flat["dense_1/kernel"] = flat["dense_1/kernel"][:, :5]   # a wrong width
    np.savez(npz, **flat)
    with pytest.raises(ValueError, match="dense_1/bias"):
        timport.import_checkpoint(npz, None, validate_only=True)
    del flat["dense_1/bias"]
    np.savez(npz, **flat)
    with pytest.raises(ValueError, match="missing .'dense_1/bias'"):
        timport.main(["--npz", npz, "--validate_only", "--task",
                      "cardinality"])
    # unknown keys and no --task: structure only, and it says so
    np.savez(npz, **{"a/b": np.zeros(2, np.float32)})
    said.lines.clear()
    timport.main(["--npz", npz, "--validate_only"])
    assert "task not identified" in said
    assert not os.path.exists(tmp_path / "a")          # nothing written


def test_validate_only_with_a_manifest_holds_shapes_and_dtypes(tmp_path,
                                                               monkeypatch):
    said = _Said(monkeypatch)
    npz = _archive(tmp_path, "relation", emb_dim=12, lstm_hidden=4,
                   head_hidden=8)
    assert timport.import_checkpoint(npz, None, validate_only=True) == 7
    assert "manifest consistent" in said
    assert "held against the relation model's" in said
    man = json.load(open(npz + ".manifest.json"))
    man["params"]["head_out/bias"]["dtype"] = "float64"
    json.dump(man, open(npz + ".manifest.json", "w"))
    with pytest.raises(ValueError, match="head_out/bias"):
        timport.import_checkpoint(npz, None, validate_only=True)
    del man["params"]["head_out/bias"]
    json.dump(man, open(npz + ".manifest.json", "w"))
    with pytest.raises(ValueError, match="unlisted .'head_out/bias'"):
        timport.import_checkpoint(npz, None, validate_only=True)


def test_fault_3_the_occupied_dir_guard_sees_config_files_too(tmp_path):
    npz = _archive(tmp_path)
    for leftover in ("model_config.json", "train_config.json", "step_3.pt",
                     "nonvisual.npz"):
        d = tmp_path / f"dir_{leftover}"
        os.makedirs(d)
        (d / leftover).write_text("{}")
        with pytest.raises(ValueError, match="fresh directory") as e:
            timport.import_checkpoint(npz, str(d))
        assert leftover in str(e.value)
        assert sorted(os.listdir(d)) == [leftover]     # nothing written
    os.makedirs(tmp_path / "notes_only")
    (tmp_path / "notes_only" / "README").write_text("x")
    assert timport.import_checkpoint(npz, str(tmp_path / "notes_only")) == 7


def test_fault_4_keys_that_do_not_form_a_tree_are_refused(tmp_path):
    z = np.zeros(2, np.float32)
    for keys, what in ((["a/b", "a/b/c"], "nests under 'a/b'"),
                       (["a", "a/b"], "nests under 'a'"),
                       (["a//b"], "empty path component"),
                       (["/a"], "empty path component")):
        path = str(tmp_path / "t.npz")
        np.savez(path, **{k: z for k in keys})
        with pytest.raises(ValueError, match="do not form a tree") as e:
            timport.import_checkpoint(path, str(tmp_path / "out"))
        assert what in str(e.value)
    timport.check_key_tree(["a/b", "a/bc", "a/b2/c", "d"])   # a tree


def test_fault_5_a_manifest_without_params_gets_its_own_message(tmp_path):
    npz = _archive(tmp_path)
    for manifest in ({"step": 3}, {"step": 3, "params": {}},
                     {"step": 3, "params": []}):
        json.dump(manifest, open(npz + ".manifest.json", "w"))
        with pytest.raises(ValueError, match="no 'params' section"):
            timport.import_checkpoint(npz, str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out")


def test_import_without_a_manifest_warns_and_needs_flags(tmp_path,
                                                         monkeypatch):
    said = _Said(monkeypatch)
    npz = _archive(tmp_path, manifest=False)
    out = str(tmp_path / "out")
    assert timport.import_checkpoint(npz, out, step=4) == 4
    assert "no manifest sidecar" in said
    assert sorted(os.listdir(out)) == ["step_4.pt"]
    with pytest.raises(SystemExit):                   # --model_file needed
        timport.main(["--npz", npz])
    with pytest.raises(ValueError, match="dense_out/kernel"):
        timport.import_checkpoint(npz, str(tmp_path / "c"), task="cardinality")
