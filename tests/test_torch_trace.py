"""The port's own spans and counters (``icl_torch.util.trace``) on the CPU.

Off (no profile running): nothing is kept and ``record_function`` is never
entered.  On, under ``torch.profiler.profile``: nesting, parents, self time
and totals, the ``icl.`` ranges in the Chrome trace, the bounded log.  The
prefetch worker cannot see the profiler's flag: its spans and counters are
kept for exactly the items taken while a profile runs.  The places that
carry spans: the batch copy to the device (``icl.h2d``), the affinity
batcher's box-row and grid-cell counters, the image tasks' train step and
the LSTM recurrence's backward, and ``--profile_dir``'s spans file; the
tape a CUDA graph's capture counts onto, launches too, and its replay.  The
recurrence's backward on autograd's device thread runs only on the card;
PERF.md gives the check made there.
"""

import contextlib
import json
import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from icl_torch.cli import affinity as taffinity
from icl_torch.cli import relation as trelation
from icl_torch.cli._common import to_device
from icl_torch.data.buckets import BucketSpec
from icl_torch.data.embeddings import EmbeddingStore
from icl_torch.data.imagebatch import AffinityBatcher, RelationBatcher
from icl_torch.data.pipeline import (AffinityDataset, AffinityImage,
                                     load_affinity_dataset,
                                     load_relation_dataset)
from icl_torch.models.relation import RelationModel
from icl_torch.testing.synth import SynthConfig, generate_dataset
from icl_torch.train import steps
from icl_torch.train.loop import prefetch
from icl_torch.train.state import create_train_state
from icl_torch.util import trace

CPU = torch.device("cpu")


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_log():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trace_data"))
    kw = dict(emb_dim=16, vocab_size=40, max_caption_len=12,
              max_mentions_per_caption=3, max_boxes_per_image=6)
    generate_dataset(d, "train", SynthConfig(num_images=10, seed=3, **kw))
    generate_dataset(d, "dev", SynthConfig(num_images=6, seed=4, **kw))
    emb = EmbeddingStore.load(os.path.join(d, "embeddings.txt"))
    return d, emb


def _batches(n):
    for i in range(n):
        with trace.span("make", i=i):
            trace.count("made", 1)
        yield to_device({"x": np.full((3, 4), i, np.float32)}, CPU)


def _relation_steps(data, n: int):
    d, emb = data
    ds = load_relation_dataset(d, "train", emb)
    model = RelationModel(emb.dim, 8, 16, fused=True, dropout=0.5)
    state = create_train_state(model, seed=5)
    step = steps.make_relation_train_step(class_weights=[0.3, 1, 1, 1],
                                          grid_loss=True)
    table = torch.from_numpy(emb.table)
    batches = RelationBatcher(images_per_batch=4).batches(ds)
    for _, b in zip(range(n), batches):
        step(state, table, to_device(b.arrays, CPU))


def test_off_keeps_nothing_and_enters_no_record_function(monkeypatch, data):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert not trace.enabled()
    assert trace.span("x", a=1) is trace.OFF and not trace.OFF
    with trace.span("x") as sp:
        sp.set(bytes=1)
        trace.count("c", 3)
    assert [x["x"][0, 0].item() for x in prefetch(_batches(5))] == \
        [0, 1, 2, 3, 4]
    _relation_steps(data, 2)
    snap = trace.snapshot()
    assert snap == {"spans": {}, "counters": {}, "events": [], "dropped": 0}


def test_on_nesting_parents_self_time_totals_and_chrome_trace(tmp_path):
    with _profile() as prof:
        assert trace.enabled()
        with trace.span("outer", k="v"):
            time.sleep(0.02)
            with trace.span("inner"):
                time.sleep(0.03)
            with trace.span("inner") as sp:
                sp.set(bytes=7)
            trace.count("rows", 5)
            trace.count("rows", 2)
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    snap = trace.snapshot()
    ev = {e["id"]: e for e in snap["events"]}
    assert len(ev) == 3
    (o,) = [e for e in ev.values() if e["name"] == "icl.outer"]
    inner = [e for e in ev.values() if e["name"] == "icl.inner"]
    assert o["parent"] is None and o["attrs"] == {"k": "v"}
    assert all(e["parent"] == o["id"] for e in inner)
    assert [e["attrs"] for e in inner] == [{}, {"bytes": 7}]
    assert o["thread"] == threading.get_native_id()
    assert all(e["start_ns"] >= o["start_ns"] and e["end_ns"] <= o["end_ns"]
               for e in inner)
    s = snap["spans"]
    assert s["icl.inner"]["count"] == 2 and s["icl.outer"]["count"] == 1
    dur = {k: (e["end_ns"] - e["start_ns"]) * 1e-9 for k, e in ev.items()}
    assert s["icl.outer"]["seconds"] == pytest.approx(dur[o["id"]])
    assert s["icl.inner"]["seconds"] == pytest.approx(
        sum(dur[e["id"]] for e in inner))
    assert s["icl.outer"]["self_seconds"] == pytest.approx(
        dur[o["id"]] - s["icl.inner"]["seconds"])
    assert s["icl.outer"]["self_seconds"] >= 0.02
    assert s["icl.inner"]["self_seconds"] == s["icl.inner"]["seconds"]
    assert snap["counters"] == {"rows": 7}
    with open(path, encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"icl.outer", "icl.inner"} <= names
    # after the profile: nothing more is kept
    with trace.span("outer"):
        trace.count("rows", 1)
    assert trace.snapshot()["spans"]["icl.outer"]["count"] == 1


def test_the_log_is_capped_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(trace, "MAX_EVENTS", 5)
    with _profile():
        for _ in range(8):
            with trace.span("x"):
                pass
    snap = trace.snapshot()
    assert len(snap["events"]) == 5 and snap["dropped"] == 3
    assert snap["spans"]["icl.x"]["count"] == 8


def test_records_from_many_threads_lose_no_update():
    """The main thread and autograd's device thread record at once on the
    card; here more threads than cores add to the same totals."""
    threads, each = 3 * (os.cpu_count() or 1), 300
    made = []
    for _ in range(threads):
        held = trace.hold("w", lambda: trace.count("n", 1))[1]
        made.append(held)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda h=h: [trace._record(h.events, h.counts)
                                for _ in range(each)])
            for h in made]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    snap = trace.snapshot()
    assert snap["counters"] == {"n": threads * each}
    assert snap["spans"]["icl.w"]["count"] == threads * each


def test_prefetch_keeps_worker_spans_for_exactly_the_items_taken_profiled():
    it = prefetch(_batches(12), depth=3)
    got = [next(it) for _ in range(2)]       # before: dropped
    time.sleep(0.05)                          # the worker fills its queue
    with _profile():
        got += [next(it) for _ in range(4)]
    got += list(it)                           # after: dropped
    assert [x["x"][0, 0].item() for x in got] == list(range(12))
    snap = trace.snapshot()
    s = snap["spans"]
    assert s["icl.prefetch.produce"]["count"] == 4
    assert s["icl.prefetch.wait"]["count"] == 4
    assert s["icl.make"]["count"] == 4 and s["icl.h2d"]["count"] == 4
    assert snap["counters"] == {"made": 4}
    ev = snap["events"]
    produced = {e["id"]: e for e in ev if e["name"] == "icl.prefetch.produce"}
    made = [e for e in ev if e["name"] == "icl.make"]
    assert sorted(e["attrs"]["i"] for e in made) == [2, 3, 4, 5]
    assert all(e["parent"] in produced for e in made)
    main = threading.get_native_id()
    assert all(e["thread"] != main for e in produced.values())
    assert all(e["thread"] == main for e in ev
               if e["name"] == "icl.prefetch.wait")
    # the worker's own time excludes its children's
    assert s["icl.prefetch.produce"]["self_seconds"] == pytest.approx(
        s["icl.prefetch.produce"]["seconds"] - s["icl.make"]["seconds"]
        - s["icl.h2d"]["seconds"])


def test_h2d_span_counts_the_bytes_and_arrays_it_copies():
    arrays = {"a": np.zeros((2, 3), np.float32),
              "b": (np.ones(5, np.int32), np.zeros((4,), bool)),
              "c": torch.zeros(3, dtype=torch.bfloat16)}
    with _profile():
        out = to_device(arrays, CPU)
    assert out["b"][0].tolist() == [1] * 5
    (h2d,) = trace.snapshot()["events"]
    assert h2d["name"] == "icl.h2d"
    assert h2d["attrs"] == {"bytes": 24 + 20 + 4 + 6, "arrays": 4,
                            "pool_allocs": 0, "pool_alloc_us": 0}


@pytest.mark.parametrize("with_ids", [True, False])
def test_affinity_box_row_counters_are_the_staged_and_the_valid_rows(
        data, with_ids):
    d, emb = data
    ds = load_affinity_dataset(d, "train", emb)
    batcher = AffinityBatcher(images_per_batch=3,
                              box_spec=BucketSpec((4, 8)),
                              with_ids=with_ids)
    with _profile():
        batches = list(batcher.batches(ds))
    staged = sum(b.arrays["box_valid"].size for b in batches)
    real = sum(int(b.arrays["box_valid"].sum()) for b in batches)
    assert real == sum(im.box_feats.shape[0] for im in ds.images)
    assert real < staged       # a short last batch and bucket padding
    grid = sum(b.arrays["grid_valid"].size for b in batches)
    cells = sum(int(b.arrays["grid_valid"].sum()) for b in batches)
    assert trace.snapshot()["counters"] == {
        "batch.box_rows": staged, "batch.box_rows_real": real,
        "batch.grid_cells": grid, "batch.grid_cells_real": cells}


def _hand_image(img_id: str, M: int, nb: int, valid) -> AffinityImage:
    return AffinityImage(
        img_id=img_id, phrase_tokens=np.ones((M, 4), np.int32),
        phrase_len=np.full(M, 2, np.int32),
        mention_ids=[f"doc:{img_id};caption:0;mention:{r}" for r in range(M)],
        box_feats=np.ones((nb, 5), np.float32), box_idx=list(range(nb)),
        grid_label=np.zeros((M, nb), np.int32),
        grid_valid=np.asarray(valid, bool).reshape(M, nb))


@pytest.mark.parametrize("profiled", [True, False])
def test_affinity_grid_cell_counters_on_a_hand_built_batch(profiled):
    """Two images in one (M, B) = (4, 4) bucket of a 3-image batch: the
    grid is 3 x 4 x 4 = 48 cells, of which 3 + 4 = 7 are candidates (one
    image's cells partly left out, as a .feats file may leave them)."""
    ds = AffinityDataset(images=[
        _hand_image("a.jpg", 3, 2, [1, 0, 1, 1, 0, 0]),
        _hand_image("b.jpg", 2, 3, [1, 1, 1, 1, 0, 0])], box_dim=5)
    batcher = AffinityBatcher(images_per_batch=3,
                              mention_spec=BucketSpec((4,)),
                              box_spec=BucketSpec((4,)), phrase_len=4,
                              with_ids=False)
    with _profile() if profiled else contextlib.nullcontext():
        (b,) = batcher.batches(ds)
    assert b.arrays["grid_valid"].shape == (3, 4, 4)
    counters = trace.snapshot()["counters"]
    if not profiled:
        assert counters == {}
        return
    assert counters["batch.grid_cells"] == 48
    assert counters["batch.grid_cells_real"] == 7
    assert counters["batch.box_rows"] == 12
    assert counters["batch.box_rows_real"] == 5


@pytest.mark.parametrize("profiled", [False, True])
def test_a_tape_takes_the_counts_of_every_thread_not_under_hold(profiled):
    """What a CUDA graph's capture counts goes on the tape, not into the
    log, profile or not, from this thread and from another (on the card,
    autograd's device thread); a worker under ``hold`` keeps its own; once
    the tape closes, counting is as before."""
    with _profile() if profiled else contextlib.nullcontext():
        with trace.tape() as counts:
            trace.count("k", 2)
            other = threading.Thread(target=trace.count, args=("k", 1))
            other.start()
            other.join(timeout=60)
            held = trace.hold("w", lambda: trace.count("h", 1))[1]
        trace.count("after", 1)
    assert not other.is_alive()
    assert sorted(counts) == [("k", 1), ("k", 2)]
    assert held.counts == [("h", 1)]
    assert trace.snapshot()["counters"] == ({"after": 1} if profiled else {})


@pytest.mark.parametrize("profiled", [False, True])
def test_replay_makes_again_the_launches_and_counts_a_tape_took(profiled):
    """A wrapper's launch count (:func:`trace.launched`) goes on the tape,
    not onto the wrapper, while the tape is open; each replay adds the
    launches to the wrapper and the counts to the log (while a profile
    runs), as the work would have."""
    wrapper = SimpleNamespace(launches=5, mma_launches=0)
    with _profile() if profiled else contextlib.nullcontext():
        trace.launched(wrapper)
        with trace.tape() as counts:
            trace.launched(wrapper)
            trace.launched(wrapper, True, "mma_launches")
            trace.count("k", 2)
        assert (wrapper.launches, wrapper.mma_launches) == (6, 0)
        for _ in range(3):
            trace.replay(counts)
    assert (wrapper.launches, wrapper.mma_launches) == (9, 3)
    assert trace.snapshot()["counters"] == ({"k": 6} if profiled else {})


def test_relation_train_step_records_its_phases_once_a_step(data):
    with _profile():
        _relation_steps(data, 3)
    snap = trace.snapshot()
    s = snap["spans"]
    for name in ("icl.train.step", "icl.train.forward", "icl.train.backward",
                 "icl.train.optimizer"):
        assert s[name]["count"] == 3, name
    # one BiLSTM call a step; on the CPU its backward runs on this thread
    assert s["icl.lstm.backward"]["count"] == 3
    ev = snap["events"]
    step_ids = {e["id"] for e in ev if e["name"] == "icl.train.step"}
    by_id = {e["id"]: e for e in ev}
    for e in ev:
        if e["name"] in ("icl.train.forward", "icl.train.backward",
                         "icl.train.optimizer"):
            assert e["parent"] in step_ids
        if e["name"] == "icl.lstm.backward":
            assert by_id[e["parent"]]["name"] == "icl.train.backward"
    phases = sum(s[n]["seconds"] for n in ("icl.train.forward",
                                           "icl.train.backward",
                                           "icl.train.optimizer"))
    assert phases <= s["icl.train.step"]["seconds"]
    assert s["icl.train.step"]["self_seconds"] == pytest.approx(
        s["icl.train.step"]["seconds"] - phases)


def _spans_file(directory) -> tuple[list, dict]:
    (name,) = [f for f in os.listdir(directory) if f.startswith("spans_")]
    assert name == f"spans_{os.getpid()}.jsonl"
    assert os.path.exists(os.path.join(directory, f"trace_{os.getpid()}.json"))
    with open(os.path.join(directory, name), encoding="utf-8") as f:
        lines = [json.loads(x) for x in f]
    return lines[:-1], lines[-1]


@pytest.mark.parametrize("task,mode", [("relation", "train"),
                                       ("relation", "predict"),
                                       ("affinity", "train"),
                                       ("affinity", "predict")])
def test_profile_dir_writes_the_chrome_trace_and_the_spans_file(
        data, tmp_path, task, mode):
    d, _ = data
    cli = {"relation": trelation, "affinity": taffinity}[task]
    prof = tmp_path / "prof"
    argv = [f"--{mode}", "--data_dir", d, "--device", "cpu", "--fused", "on",
            "--images_per_batch", "4", "--lstm_hidden_width", "8",
            "--head_hidden", "16", "--model_file", str(tmp_path / "m"),
            "--profile_dir", str(prof)]
    if mode == "train":
        argv += ["--epochs", "1", "--ckpt_every", "0"]
    else:
        argv += ["--data_split", "dev", "--scores_file",
                 str(tmp_path / "s.scores")]
    cli.main(argv)
    events, totals = _spans_file(prof)
    names = {e["name"] for e in events}
    assert {"icl.prefetch.produce", "icl.prefetch.wait", "icl.h2d"} <= names
    if mode == "train":
        assert {"icl.train.step", "icl.train.backward",
                "icl.lstm.backward"} <= names
    else:
        assert "icl.train.step" not in names
    assert set(totals) == {"spans", "counters", "dropped"}
    assert totals["spans"]["icl.h2d"]["count"] == sum(
        e["name"] == "icl.h2d" for e in events)
    assert ("batch.box_rows" in totals["counters"]) == (task == "affinity")
    # the file holds the profile's spans; the log is empty after it
    assert trace.snapshot()["events"] == []


def _mention_sweep_and_writes(tmp_path):
    """A ten-mention sweep in batches of four, its ``.scores`` and a rank
    file written, through the task CLIs' shared functions."""
    from icl_torch.cli import _predict
    from icl_torch.data.buckets import Bucketizer

    ids = [f"doc:x;caption:0;mention:{k}" for k in range(10)]
    arrays = {"token_ids": np.arange(10, dtype=np.int32)[:, None],
              "lengths": np.ones(10, np.int32)}
    batches = (b for _, b in Bucketizer(BucketSpec((1,)), batch_size=4)
               .batches(arrays["lengths"], arrays, ids))
    rows = _predict.predict_in_order(
        batches, CPU, lambda a: a["token_ids"].float().repeat(1, 2) / 10,
        _predict.mention_rows, ids, "mentions", 2, "nonvisual")
    args = SimpleNamespace(scores_file=str(tmp_path / "n.scores"),
                           data_split="dev", data_dir=None)
    _predict.write_scores(args, "nonvisual", ("visual", "nonvisual"), ids,
                          rows, len(ids), 0)
    taffinity.write_rank(str(tmp_path / "a.rank"), "dev", ids, rows[:, :1],
                         len(ids), True)
    return rows


@pytest.mark.parametrize("profiled", [False, True])
def test_the_predict_sweep_and_the_scores_writes_are_spans(
        profiled, tmp_path, monkeypatch):
    if not profiled:
        def refuse(*a, **k):
            raise AssertionError("record_function entered with tracing off")
        monkeypatch.setattr(trace, "record_function", refuse)
    with _profile() if profiled else contextlib.nullcontext():
        rows = _mention_sweep_and_writes(tmp_path)
    np.testing.assert_allclose(rows[:, 0], np.arange(10) / 10, rtol=1e-6)
    assert open(tmp_path / "n.scores").read().count("\n") == 10
    snap = trace.snapshot()
    if not profiled:
        assert snap == {"spans": {}, "counters": {}, "events": [],
                        "dropped": 0}
        return
    sweeps = [e for e in snap["events"] if e["name"] == "icl.sweep"]
    assert [e["attrs"] for e in sweeps] == [
        {"task": "nonvisual", "unit": "mentions", "examples": 10}]
    # the prefetch worker's spans and the copies lie inside the sweep
    inside = {e["parent"] for e in snap["events"]
              if e["name"] == "icl.prefetch.wait"}
    assert inside == {sweeps[0]["id"]}
    writes = [e["attrs"] for e in snap["events"]
              if e["name"] == "icl.scores.write"]
    assert writes == [{"task": "nonvisual", "rows": 10},
                      {"task": "affinity_rank", "rows": 10}]
    # one count a batch read back, each of its examples
    assert snap["counters"] == {"predict.mentions": 10}
