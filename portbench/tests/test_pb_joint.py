"""The joint cell's own parts on the CPU: the manifest lists the cell, its
configuration at the published widths and its eight metrics; each new
reader reads a canned trace and snapshot, and gives None with nothing to
read; the work counts on a hand-made batch; the new driver imports no
kernel of the port, the new reference nothing of the program; a traced run
at a tiny size reports the program's spans."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from portbench.lib import cell as cells
from portbench.lib import spans
from portbench.lib.trace import Trace
from portbench.tests.conftest import ROOT, measure, tiny_cell

CELL = "joint.predict"
METRICS = ["idle_share.joint_predict", "mfu.joint_predict",
           "grid_head_roofline.joint_predict",
           "sweep_share_relation.joint_predict",
           "sweep_share_affinity.joint_predict",
           "sweep_share_mention.joint_predict",
           "scores_write_ms.joint_predict",
           "launches_per_batch.joint_predict"]
REL_HEAD = ("void (anonymous namespace)::grid_head_kernel<4, true, 4>"
            "(icl_head::HeadArgs)")
AFF_HEAD = ("void (anonymous namespace)::grid_head_kernel<2, true, 4>"
            "(icl_head::HeadArgs)")


def test_the_manifest_lists_the_cell_its_configuration_and_metrics():
    bench = cells.manifest()
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        "joint-flickr30k", "joint_sweep", 1)
    (c,) = [c for c in bench["configs"] if c["name"] == "joint-flickr30k"]
    assert c["reduced"] == [] and c["file"].endswith("joint-flickr30k.json")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert CELL in e2e["cells_per_s"]["workloads"]
    assert "workloads" not in e2e["setup_s"]
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        assert listed[name]["workloads"] == [CELL]
        assert listed[name]["moves"] == "cells_per_s"
    got = cells.load_cell(CELL)
    assert sorted(m["name"] for m in got["per_layer"]) == sorted(METRICS)
    assert {m["name"] for m in got["end_to_end"]} == {"cells_per_s",
                                                      "setup_s"}


def test_the_configuration_is_the_published_widths_and_shapes():
    cfg = cells.load_cell(CELL)["config"]
    assert (cfg["vocab_size"], cfg["emb_dim"], cfg["lstm_hidden"]) == (
        20000, 300, 200)
    assert (cfg["relation_head_hidden"], cfg["relation_classes"]) == (800, 4)
    assert (cfg["affinity_head_hidden"], cfg["affinity_classes"],
            cfg["box_dim"]) == (1024, 2, 4096)
    assert (cfg["mention_hidden"], cfg["nonvisual_classes"],
            cfg["cardinality_classes"]) == (300, 2, 12)
    for other in ("relation-flickr30k", "affinity-flickr30k"):
        with open(os.path.join(cells.HERE, "configs", other + ".json")) as f:
            o = json.load(f)
        for k in ("captions_per_image", "caption_len_mean",
                  "caption_len_max", "mentions_per_caption_mean",
                  "mention_len_mean", "boxes_per_image_mean",
                  "boxes_per_image_max", "phrase_len", "class_prior"):
            if k in o:
                assert cfg[k] == o[k], (other, k)
    traffic = cells.load_cell(CELL)["traffic"]
    assert (traffic["images"], traffic["images_per_batch"],
            traffic["batch_size"]) == (1000, 8, 512)


def _run(events=None, window_s=1.0, snapshot=None, stats=None):
    cell = cells.load_cell(CELL)
    return {"cell": cell,
            "trace": None if events is None else Trace(events, window_s),
            spans.KEY: snapshot,
            "stats": stats if stats is not None else
            {"stats": [], "cfg": cell["config"], "batches": 0, "passes": 0}}


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _span(name, task, t0, t1):
    return {"id": t0, "name": name, "parent": None, "thread": 1,
            "start_ns": t0, "end_ns": t1, "attrs": {"task": task}}


def test_the_readers_on_a_canned_window():
    cfg = cells.load_cell(CELL)["config"]
    work = cells.work(cells.load_cell(CELL))
    rel = {"task": "relation", "I": 8, "M": 16, "tokens": 480,
           "mentions": 128, "pairs": 960}
    aff = {"task": "affinity", "I": 8, "M": 16, "L": 16, "B": 16,
           "tokens": 300, "phrases": 128, "boxes": 70, "cells": 1100}
    men = {"task": "nonvisual", "rows": 512, "tokens": 1180}
    events = [_kernel(REL_HEAD, 0, 40), _kernel(AFF_HEAD, 100, 30),
              _kernel("gemm", 200, 400), _kernel(REL_HEAD, 700, 60)]
    snap = {"spans": {"icl.scores.write": {"count": 10, "seconds": 0.4,
                                           "self_seconds": 0.4}},
            "counters": {"predict.pairs": 960},
            "events": [_span("icl.sweep", "relation", 0, 200_000_000),
                       _span("icl.sweep", "affinity", 3 * 10 ** 8,
                             4 * 10 ** 8),
                       _span("icl.sweep", "nonvisual", 5 * 10 ** 8,
                             5 * 10 ** 8 + 50_000_000),
                       _span("icl.sweep", "cardinality", 6 * 10 ** 8,
                             6 * 10 ** 8 + 50_000_000),
                       _span("icl.scores.write", "relation", 0, 10)]}
    run = _run(events, 1.0, snap, {"stats": [rel, aff, men], "cfg": cfg,
                                   "batches": 4, "passes": 2})

    def read(name):
        return cells.metric_reader(name).read(run)

    assert read("idle_share.joint_predict") == pytest.approx(
        100 - 530e-6 * 100)
    flops = sum(work.flops(s, cfg) for s in (rel, aff, men))
    assert read("mfu.joint_predict") == pytest.approx(flops / 67e12 * 100)
    assert read("grid_head_roofline.joint_predict") == pytest.approx(
        work.grid_head_bound_s(rel, cfg) / 100e-6 * 100)
    assert read("sweep_share_relation.joint_predict") == pytest.approx(20.0)
    assert read("sweep_share_affinity.joint_predict") == pytest.approx(10.0)
    assert read("sweep_share_mention.joint_predict") == pytest.approx(10.0)
    assert read("scores_write_ms.joint_predict") == pytest.approx(200.0)
    assert read("launches_per_batch.joint_predict") == pytest.approx(1.0)


@pytest.mark.parametrize("what", ["no trace", "no tracer", "nothing kept"])
def test_the_readers_give_none_with_nothing_to_read(what):
    empty = {"spans": {}, "counters": {}, "events": [], "dropped": 0}
    run = _run(None if what == "no trace" else [], 1.0,
               None if what == "no tracer" else empty)
    for name in METRICS:
        assert cells.metric_reader(name).read(run) is None, name


def test_the_work_counts_on_a_hand_made_batch():
    work = cells.work(cells.load_cell(CELL))
    cfg = {"emb_dim": 3, "lstm_hidden": 2, "relation_head_hidden": 5,
           "relation_classes": 4, "affinity_head_hidden": 5,
           "affinity_classes": 2, "box_dim": 7, "mention_hidden": 6,
           "nonvisual_classes": 2, "cardinality_classes": 12}
    ra = {"tok_len": np.array([[3, 2]]), "tokens": np.zeros((1, 2, 4)),
          "m_cap": np.zeros((1, 4)), "m_valid": np.array([[1, 1, 1, 0]]),
          "pair_valid": np.array([[1, 1, 1, 0, 0, 0]])}
    rs = work.stats("relation", ra, 3, cfg)
    assert rs == {"task": "relation", "I": 1, "M": 4, "tokens": 5,
                  "mentions": 3, "pairs": 3}
    assert work.flops(rs, cfg) == (2 * 5 * 2 * 3 * 8 + 2 * 5 * (32 + 20)
                                   + 3 * 2 * 2 * 8 * 5 + 3 * 5
                                   + 3 * 5 * 10 + 3 * 24)
    ops = 1 * 4 * 5 + 16 * 5 * 10
    nbytes = 4 * (20 + 20 + 5 + 20 + 4 + 64)
    assert work.grid_head_bound_s(rs, cfg) == pytest.approx(
        max(ops / 67e12, nbytes / 3.35e12))
    ma = {"token_ids": np.zeros((4, 16)), "lengths": np.array([2, 1, 3, 0])}
    ms = work.stats("cardinality", ma, 3, cfg)
    assert ms == {"task": "cardinality", "rows": 3, "tokens": 6}
    assert work.flops(ms, cfg) == ((6 + 3) * 3 + 3 * (36 + 12 + 144 + 12)
                                   + 3 * 72)
    aa = {"phrase_len": np.array([[2, 1, 0]]),
          "phrase_tokens": np.zeros((1, 3, 4), np.int32),
          "box_valid": np.array([[True, True, False, False]])}
    s = work.stats("affinity", aa, 4, cfg)
    assert s["task"] == "affinity" and s["cells"] == 4
    aff = cells.load_module(cells.part("work", "affinity-flickr30k.predict"))
    assert work.flops(s, cfg) == aff.flops(s, {
        "emb_dim": 3, "lstm_hidden": 2, "head_hidden": 5,
        "num_classes": 2, "box_dim": 7})


def test_the_driver_imports_no_kernel_and_the_reference_nothing_of_it():
    src = open(cells.part("drivers", "joint_predict"), encoding="utf-8").read()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|icl\b|icl\.|"
                         r"icl_torch\.ops|icl_torch\.csrc)", src, re.M)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.lib import cell\n"
            "cell.load_module(cell.part('reference', "
            "'joint-flickr30k.predict'))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('icl_torch', 'icl', 'jax', 'flax'))\n"
            "assert not bad, bad\n") % ROOT
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_a_tiny_traced_run_reports_the_program_spans():
    out = measure(tiny_cell(CELL), 2 ** 31 + 11, seconds=0.3, trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    shares = [got[f"sweep_share_{t}.joint_predict"]["value"]
              for t in ("relation", "affinity", "mention")]
    assert all(0 < s < 100 for s in shares) and sum(shares) < 100
    assert got["scores_write_ms.joint_predict"]["value"] > 0
