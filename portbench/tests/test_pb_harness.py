"""The harness's own parts on the CPU: the manifest and its files, the
generators, the work counts and the trace reading."""

from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest

from portbench.lib import cell as cells
from portbench.lib import synth
from portbench.lib.trace import Trace

BENCH = cells.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(name):
    c = cells.load_cell(name, BENCH)
    assert os.path.exists(cells.part("drivers", c["spec"]["driver"]))
    for kind in ("work", "reference"):
        assert os.path.exists(cells.part(
            kind, f"{c['config']['name']}.{c['spec']['entry']}"))
    assert set(c["spec"]["limits"]) and c["chips"] == 1
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e
        assert hasattr(cells.metric_reader(m["name"]), "read")


def test_every_config_is_used_and_stated():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = json.load(open(os.path.join(cells.ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]


@pytest.mark.parametrize("kind", ["relation", "affinity"])
def test_generators_fixed_per_seed_same_sizes(kind):
    cfg = json.load(open(os.path.join(cells.HERE, "configs",
                                      f"{kind}-flickr30k.json")))
    make = getattr(synth, f"{kind}_images")
    a, b, c = make(cfg, 60, 7), make(cfg, 60, 7), make(cfg, 60, 2 ** 31 + 9)

    def sizes(ims):
        return sorted((tuple(len(x) for x in im["captions"]),
                       len(im["mentions"]), im.get("n_boxes", 0))
                      for im in ims)

    assert [im["captions"][0].tolist() for im in a] == \
        [im["captions"][0].tolist() for im in b]
    assert sizes(a) == sizes(c)                  # the same multiset of sizes
    assert [im["captions"][0].tolist() for im in a] != \
        [im["captions"][0].tolist() for im in c]
    for im in a:
        assert all(4 <= len(x) <= cfg.get("caption_len_max", 32)
                   for x in im["captions"])
        for ci, f, l in im["mentions"]:
            assert 0 <= f <= l < len(im["captions"][ci])
    mentions = np.mean([len(im["mentions"]) for im in make(cfg, 400, 1)])
    assert 13 < mentions < 19                    # about 16 an image
    if kind == "affinity":
        boxes = np.mean([im["n_boxes"] for im in make(cfg, 400, 1)])
        assert 7.5 < boxes < 10                  # about 8.7 an image
    else:
        im = a[0]
        M = len(im["mentions"])
        assert len(im["pairs"]) == M * (M - 1) // 2


def test_work_counts_tiny():
    aff = cells.load_module(cells.part("work", "affinity-flickr30k.predict"))
    cfg = {"emb_dim": 3, "lstm_hidden": 2, "head_hidden": 5,
           "num_classes": 2, "box_dim": 7}
    arrays = {"phrase_len": np.array([[2, 1, 0]]),
              "phrase_tokens": np.zeros((1, 3, 4), np.int32),
              "box_valid": np.array([[True, True, False, False]])}
    s = aff.stats(arrays, cfg)
    assert s == {"I": 1, "M": 3, "L": 4, "B": 4, "tokens": 3, "phrases": 2,
                 "boxes": 2, "cells": 4}
    want = (3 * 2 * 3 * 8 + 3 * (8 * 4 + 20) + 2 * 2 * 2 * 5 + 2 * 2 * 7 * 5
            + 2 * 5 + 4 * 5 * 6 + 4 * 2 * 5 + 4 * 18)
    assert aff.flops(s, cfg) == want
    nbytes = 4 * 3 * 8 * 4 + 4 * 3 + 2 * 8 * 4 + 4 * 3 * 2 * 4 + 3 * 2 * 4
    assert aff.lstm_bound_s(s, cfg) == pytest.approx(
        max(3 * 20 / 67e12, 3 * 3 * 32 / 494.7e12, nbytes / 3.35e12))
    rel = cells.load_module(cells.part("work", "relation-flickr30k.train"))
    rcfg = {"emb_dim": 3, "lstm_hidden": 2, "head_hidden": 5,
            "num_classes": 4}
    ra = {"tok_len": np.array([[3, 2]]), "tokens": np.zeros((1, 2, 4)),
          "m_cap": np.zeros((1, 4)), "m_valid": np.array([[1, 1, 1, 0]]),
          "pair_valid": np.array([[1, 1, 1, 0, 0, 0]])}
    rs = rel.stats(ra, rcfg)
    assert rs == {"I": 1, "C": 2, "L": 4, "M": 4, "tokens": 5,
                  "mentions": 3, "pairs": 3}
    proj, rec, ment = 2 * 5 * 2 * 3 * 8, 2 * 5 * (32 + 20), 3 * 2 * 2 * 8 * 5
    head, soft = 3 * 5 + 3 * 5 * 10, 3 * 24
    bwd = 3 * 5 * (6 + 16 + 2) + 3 * 8 * 4
    assert rel.flops(rs, rcfg) == (2 * proj + 3 * rec + 3 * ment + head
                                   + 3 * 5 + soft + bwd)
    assert rel.ght_loss_bwd_bound_s(rs, rcfg) > 0


def test_trace_reading():
    ev = [{"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10,
           "args": {"grid": [3, 1, 1]}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 5, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 40, "dur": 25},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 80, "dur": 10},
          {"ph": "X", "cat": "user_annotation", "name": "pb.outer", "ts": 0,
           "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "pb.inner", "ts": 12,
           "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
           "dur": 3}]
    t = Trace(ev, window_s=100e-6)
    assert t.busy_intervals() == [(0.0, 15.0), (40.0, 65.0), (80.0, 90.0)]
    assert t.busy_s() == pytest.approx(50e-6)
    assert t.idle_share() == pytest.approx(50.0)
    assert [k[0] for k in t.kernels("k1")] == ["k1", "k1"]
    assert t.top_ops()[0] == ["k2", pytest.approx(25e-6)]
    gaps = dict(t.idle_gaps())
    assert gaps == {"inner": pytest.approx(25e-6),
                    "outer": pytest.approx(15e-6)}
