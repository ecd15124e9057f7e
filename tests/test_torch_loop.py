"""icl_torch train loop, checkpoints and eval hook (CPU, f32).

Resume: a run killed mid-epoch with shuffling on and continued with
``resume="auto"`` ends with the same weights and Adam state, bit for bit,
as an uninterrupted run, at dropout 0.5, so ``TrainState.dropout_seeds``
reproduces once ``step`` is restored.  Checkpoints: atomic writes,
``max_to_keep``, ``force``, ``delete``, a background save's exception.
Early stop with restore-best and pruning; the planted convergence gates
through the CLIs.  Against the JAX package (same exported weights, same
batches, dropout 0): five steps of ``run_training`` give losses within 1e-4
and the same JSONL keys; ``make_grid_eval_fn`` agrees within 1e-5 and does
not depend on how the eval set is cut into batches.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl.cli.export import flatten_params
from icl.data.imagebatch import RelationBatcher
from icl.data.pipeline import load_relation_dataset
from icl.dist.mesh import build_mesh
from icl.models import RelationModel as JaxRelationModel
from icl.train import evalhook as jax_evalhook
from icl.train import loop as jax_loop
from icl.train import steps as jax_steps
from icl.train.state import create_train_state as jax_create_train_state
from icl_torch.io.feats import read_feats
from icl_torch.io.scores import read_scores
from icl_torch.models.affinity import AffinityModel
from icl_torch.models.relation import RelationModel
from icl_torch.testing.synth import SynthConfig, generate_dataset
from icl_torch.train import checkpoint as ckpt_mod
from icl_torch.train import steps
from icl_torch.train.checkpoint import Checkpointer
from icl_torch.train.evalhook import _host_cell_weights, make_grid_eval_fn
from icl_torch.train.loop import (LoopConfig, _batch_examples, prefetch,
                                  run_training)
from icl_torch.train.state import create_train_state

LSTM_H, HEAD_H = 8, 16
CW = [0.3, 1.0, 1.0, 1.0]


class Killed(Exception):
    """Stands for the process dying inside a step."""


def _relation_setup(synth_dir, emb, dropout=0.5, seed=9):
    ds = load_relation_dataset(synth_dir, "train", emb)
    batcher = RelationBatcher(images_per_batch=3, build_grid=True)
    table = torch.from_numpy(emb.table)
    step = steps.make_relation_train_step(class_weights=CW, grid_loss=True)

    def make_state():
        model = RelationModel(emb.dim, LSTM_H, HEAD_H, fused=True,
                              dropout=dropout)
        return create_train_state(model, seed=seed)

    def make_batches(epoch_rng, skip=0):     # shuffled: order needs the rng
        for b in batcher.batches(ds, rng=epoch_rng, skip=skip):
            yield ({k: torch.from_numpy(v) for k, v in b.arrays.items()},)

    return make_state, make_batches, (lambda s, b: step(s, table, b))


def _assert_same_state(a, b):
    assert a.step == b.step and a.seed == b.seed
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"]) and oa["state"]
    for i, slot in oa["state"].items():
        for name, t in slot.items():
            assert torch.equal(t, ob["state"][i][name]), (i, name)


@pytest.mark.parametrize("kill_at,ckpt_every", [(7, 5), (6, 2), (9, 1)])
def test_kill_mid_epoch_and_resume_is_bit_identical(tmp_path, synth_dir, emb,
                                                    kill_at, ckpt_every):
    make_state, make_batches, step_fn = _relation_setup(synth_dir, emb)
    per_epoch = sum(1 for _ in make_batches(np.random.default_rng(0)))
    assert per_epoch == 4 and kill_at % per_epoch     # dies inside an epoch
    straight = run_training(make_state(), step_fn, make_batches,
                            LoopConfig(epochs=3, seed=9))
    assert straight.step == 3 * per_epoch

    def dying(s, b):
        if s.step == kill_at:
            raise Killed
        return step_fn(s, b)

    ck = str(tmp_path / "ck")
    with pytest.raises(Killed):
        run_training(make_state(), dying, make_batches,
                     LoopConfig(epochs=3, ckpt_dir=ck, ckpt_every=ckpt_every,
                                seed=9))
    # the newest periodic save (the one before it if the kill outran the
    # background write); never the end marker
    latest = Checkpointer(ck).latest_step
    assert latest is not None and latest % ckpt_every == 0
    assert kill_at - 2 * ckpt_every < latest <= kill_at
    resumed = run_training(make_state(), step_fn, make_batches,
                           LoopConfig(epochs=3, ckpt_dir=ck, ckpt_every=0,
                                      resume="auto", seed=9))
    _assert_same_state(resumed, straight)
    # the end marker: a further resume trains nothing more
    again = run_training(make_state(), step_fn, make_batches,
                         LoopConfig(epochs=3, ckpt_dir=ck, ckpt_every=0,
                                    resume="auto", seed=9))
    _assert_same_state(again, straight)


def test_dropout_seeds_are_a_function_of_seed_and_step(synth_dir, emb):
    make_state, _, _ = _relation_setup(synth_dir, emb)
    a, b = make_state(), make_state()
    a.step, b.step = 5, 5
    assert torch.equal(a.dropout_seeds(7), b.dropout_seeds(7))
    b.step = 6
    assert not torch.equal(a.dropout_seeds(7), b.dropout_seeds(7))
    b.step, b.seed = 5, a.seed + 1
    assert not torch.equal(a.dropout_seeds(7), b.dropout_seeds(7))


def _tiny_state(seed=0):
    model = AffinityModel(emb_dim=6, box_dim=5, lstm_hidden=4, head_hidden=8,
                          fused=False, dropout=0.0)
    state = create_train_state(model, seed=seed)
    # one update, so Adam has moments to save
    loss = sum((p ** 2).sum() for p in model.parameters())
    loss.backward()
    state.apply_gradients()
    return state


def test_a_kill_before_the_rename_leaves_the_previous_checkpoint(
        tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))
    first = _tiny_state()
    ck.save(first, wait=True, epoch=1, batch_in_epoch=2)
    later = _tiny_state(seed=1)
    later.step = 5

    def killed(*_a, **_k):
        raise Killed

    monkeypatch.setattr(ckpt_mod.os, "replace", killed)
    with pytest.raises(Killed):
        ck.save(later, wait=True)
    monkeypatch.undo()
    leavings = [n for n in os.listdir(tmp_path) if n.startswith(".tmp_step_")]
    assert len(leavings) == 1                  # written, never renamed
    fresh = Checkpointer(str(tmp_path))        # a new process
    assert fresh.all_steps() == [1]
    got, epoch, batch = fresh.restore_with_position(_tiny_state(seed=3))
    assert (epoch, batch) == (1, 2)
    _assert_same_state(got, first)
    fresh.save(later, wait=True)               # the next save sweeps them
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    assert fresh.all_steps() == [1, 5]


def test_checkpointer_keeps_three_forces_and_deletes(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=3)
    assert ck.latest_step is None and ck.all_steps() == []
    state = _tiny_state()
    untouched = _tiny_state(seed=4)
    assert ck.restore(untouched) is untouched and untouched.step == 1
    for step in (2, 4, 6, 8):
        state.step = step
        ck.save(state, epoch=step, batch_in_epoch=1)     # in the background
    assert ck.all_steps() == [4, 6, 8] and ck.latest_step == 8
    with pytest.raises(FileExistsError):
        ck.save(state)
    with torch.no_grad():
        state.model.head_out.bias.add_(1.0)
    ck.save(state, wait=True, epoch=99, force=True)      # replaces step 8
    got, epoch, _ = ck.restore_with_position(_tiny_state(seed=5))
    assert epoch == 99
    _assert_same_state(got, state)
    ck.delete(8)
    assert ck.all_steps() == [4, 6] and ck.latest_step == 6
    ck.wait()
    ck.close()


def test_a_background_save_copies_the_state_first(tmp_path):
    """The periodic save returns before the write; a later in-place update
    of the live weights must not reach the file."""
    ck = Checkpointer(str(tmp_path))
    state = _tiny_state()
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    ck.save(state, epoch=0, batch_in_epoch=1)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(7.0)
    got = ck.restore(_tiny_state(seed=2))
    for k, v in got.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_a_background_saves_exception_is_raised_at_the_next_call(
        tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path))

    def broken(*_a, **_k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", broken)
    ck.save(_tiny_state())                      # returns: the write is behind
    with pytest.raises(OSError, match="disk full"):
        ck.latest_step
    monkeypatch.undo()
    assert ck.latest_step is None               # raised once, then clean


@pytest.mark.parametrize("losses,patience,stop_step,best_step", [
    ([1.0, 0.9, 0.9, 0.9, 0.8, 0.8], 2, 4, 2),
    ([1.0, 1.1, 0.5, 0.6, 0.7, 0.1], 2, 5, 3),
    ([1.0, 1.0], 1, 2, 1)])
def test_early_stop_restores_best_and_prunes(tmp_path, synth_dir, emb, losses,
                                             patience, stop_step, best_step):
    make_state, make_batches, step_fn = _relation_setup(synth_dir, emb)
    seen, it = {}, iter(losses)

    def eval_fn(s):
        seen[s.step] = {k: v.clone()
                        for k, v in s.model.state_dict().items()}
        return {"loss": next(it), "acc": 0.5}

    metrics = str(tmp_path / "m.jsonl")
    final = run_training(make_state(), step_fn, make_batches,
                         LoopConfig(epochs=10, ckpt_dir=str(tmp_path / "ck"),
                                    ckpt_every=1, eval_every=1,
                                    early_stop=patience, seed=9,
                                    metrics_path=metrics),
                         eval_fn=eval_fn)
    assert max(seen) == stop_step and final.step == best_step
    for k, v in final.model.state_dict().items():
        assert torch.equal(v, seen[best_step][k]), k
    ck = Checkpointer(str(tmp_path / "ck"))
    assert ck.latest_step == best_step
    assert all(s <= best_step for s in ck.all_steps())
    evals = [json.loads(line) for line in open(metrics)]
    assert [e["step"] for e in evals] == list(range(1, stop_step + 1))
    assert sorted(evals[0]) == ["epoch", "eval_acc", "eval_loss", "step"]


def test_loop_runs_to_the_epoch_cap_without_early_stop(synth_dir, emb):
    make_state, make_batches, step_fn = _relation_setup(synth_dir, emb)
    calls = []
    final = run_training(make_state(), step_fn, make_batches,
                         LoopConfig(epochs=2, eval_every=3, early_stop=0),
                         eval_fn=lambda s: calls.append(s.step) or
                         {"loss": 1.0})
    assert final.step == 8 and calls == [3, 6]


def test_prefetch_keeps_order_and_reraises():
    assert list(prefetch(iter(range(50)), depth=3)) == list(range(50))

    def bad():
        yield 1
        raise Killed

    it = prefetch(bad())
    assert next(it) == 1
    with pytest.raises(Killed):
        next(it)
    assert _batch_examples(({"grid_valid": torch.ones(2, 3, dtype=torch.bool)},
                            )) == 6
    assert _batch_examples((torch.zeros(3),)) == 0


# --- the planted convergence gates, through the CLIs ---------------------

@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_planted")
    cfg = dict(captions_per_image=3, vocab_size=16, emb_dim=16,
               max_mentions_per_caption=2, max_boxes_per_image=4,
               planted=True)
    generate_dataset(str(d), "train", SynthConfig(num_images=96, seed=1,
                                                  **cfg))
    generate_dataset(str(d), "dev", SynthConfig(num_images=24, seed=1, **cfg))
    return d


@pytest.mark.parametrize("task,epochs,gate", [("relation", 25, 0.93),
                                              ("affinity", 20, 0.95)])
def test_planted_task_converges_through_the_cli(planted, tmp_path, task,
                                                epochs, gate):
    """The reference's held-out gates (tests/integration/
    test_convergence.py), same data, widths, seed and budget."""
    import importlib

    cli = importlib.import_module(f"icl_torch.cli.{task}")
    scores = tmp_path / f"{task}.scores"
    common = ["--data_dir", str(planted), "--images_per_batch", "16",
              "--device", "cpu", "--fused", "on",
              "--model_file", str(tmp_path / f"{task}.model")]
    cli.main(["--train", "--data_split", "train", "--epochs", str(epochs),
              "--lstm_hidden_width", "24", "--head_hidden", "48",
              "--dropout", "0.0", "--seed", "3", "--learn_rate", "0.01",
              *common])
    cli.main(["--predict", "--data_split", "dev", "--scores_file",
              str(scores), *common])
    ids, probs = read_scores(str(scores))
    gold = {ex.example_id: int(ex.label)
            for ex in read_feats(str(planted / f"dev.{task}.feats"))}
    y = np.array([gold[i] for i in ids])
    assert len(y) > 90
    acc = float((y == probs.argmax(axis=1)).mean())
    assert acc >= gate, f"{task} dev accuracy {acc:.3f}"


# --- against the JAX package ------------------------------------------------

def _shared_start(synth_dir, emb):
    """A JAX relation state and the port's from the same weights, and the
    host batches both will see."""
    ds = load_relation_dataset(synth_dir, "train", emb)
    batches = [b.arrays for b in RelationBatcher(
        images_per_batch=4, build_grid=True).batches(ds)]
    jtable = jnp.asarray(emb.table)
    jmodel = JaxRelationModel(lstm_hidden=LSTM_H, head_hidden=HEAD_H,
                              dropout=0.0, fused=True)
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jstate = jax_create_train_state(jmodel, (jtable, jb0), seed=0)
    model = RelationModel(emb.dim, LSTM_H, HEAD_H, fused=True, dropout=0.0)
    state = create_train_state(model, params={
        k: v.copy() for k, v in flatten_params(jstate.params).items()})
    return batches, jtable, jmodel, jstate, model, state


def test_five_loop_steps_match_the_jax_loop(tmp_path, synth_dir, emb):
    batches, jtable, _, jstate, _, state = _shared_start(synth_dir, emb)
    schedule = [batches[i % len(batches)] for i in range(5)]
    jstep = jax_steps.make_relation_train_step(class_weights=CW,
                                               donate=False, grid_loss=True)
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    with jax.default_matmul_precision("highest"):
        jfinal = jax_loop.run_training(
            jstate, lambda s, b: jstep(s, jtable, b),
            lambda rng, skip=0: (({k: jnp.asarray(v) for k, v in b.items()},)
                                 for b in schedule[skip:]),
            jax_loop.LoopConfig(epochs=1, log_every=1, metrics_path=jpath))
    step = steps.make_relation_train_step(class_weights=CW, grid_loss=True)
    table = torch.from_numpy(emb.table)
    final = run_training(
        state, lambda s, b: step(s, table, b),
        lambda rng, skip=0: (({k: torch.from_numpy(v) for k, v in b.items()},)
                             for b in schedule[skip:]),
        LoopConfig(epochs=1, log_every=1, metrics_path=tpath))
    assert final.step == int(jfinal.step) == 5
    jrows = [json.loads(line) for line in open(jpath)]
    trows = [json.loads(line) for line in open(tpath)]
    assert len(jrows) == len(trows) == 5
    for j, t in zip(jrows, trows):
        assert sorted(j) == sorted(t) == ["acc", "epoch", "examples_per_sec",
                                          "loss", "step"]
        assert (j["epoch"], j["step"]) == (t["epoch"], t["step"])
        assert abs(j["loss"] - t["loss"]) <= 1e-4, (j, t)
        assert abs(j["acc"] - t["acc"]) <= 1e-4, (j, t)
    assert trows[-1]["loss"] < trows[0]["loss"]


@pytest.mark.parametrize("class_weights", [CW, None, [0.0, 1.0, 1.0, 1.0]])
def test_grid_eval_fn_matches_jax_and_ignores_the_batching(synth_dir, emb,
                                                           class_weights):
    batches, jtable, jmodel, jstate, model, state = _shared_start(synth_dir,
                                                                  emb)
    with jax.default_matmul_precision("highest"):
        want = jax_evalhook.make_grid_eval_fn(
            jmodel, jtable, batches, build_mesh("1"), class_weights)(jstate)
    table = torch.from_numpy(emb.table)
    got = make_grid_eval_fn(model, table, batches, class_weights)(state)
    streamed = make_grid_eval_fn(model, table, batches, class_weights,
                                 pin=False)(state)
    assert got == streamed                      # the same reduction
    for k in ("loss", "acc"):
        assert abs(got[k] - float(want[k])) <= 1e-5, (k, got, want)
    # cut the same images into other batches: sums over the whole set
    ds = load_relation_dataset(synth_dir, "train", emb)
    other = [b.arrays for b in RelationBatcher(
        images_per_batch=3, build_grid=True).batches(ds)]
    assert len(other) != len(batches)
    recut = make_grid_eval_fn(model, table, other, class_weights)(state)
    for k in ("loss", "acc"):
        assert abs(recut[k] - got[k]) <= 1e-6, (k, recut, got)
    assert not any(p.grad is not None for p in model.parameters())


def test_host_cell_weights_equal_the_steps():
    rng = np.random.default_rng(1)
    labels = rng.integers(-1, 6, size=(3, 5, 5)).astype(np.int32)
    valid = rng.random((3, 5, 5)) < 0.6
    for cw in (None, CW, [0.0, 2.5, 1.0, 0.7, 3.0]):
        want = steps._cell_weights(
            torch.from_numpy(labels), torch.from_numpy(valid),
            None if cw is None else torch.tensor(cw))
        got = _host_cell_weights(labels, valid, cw)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want.numpy())
