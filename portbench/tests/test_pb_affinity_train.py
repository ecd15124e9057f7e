"""The affinity train cell (``affinity.train.highest``) on the CPU: the
three training faults each come out not correct; the labels are fixed per
seed and leave the generator's images as the predict cell gets them; the
work file's counts on a hand-counted batch; the new readers on a traced
run, and None where there is nothing to read.  On the card (marked
``cuda``): the faults at the cell's own size on three seeds, each printing
``READING`` as ``test_pb_control.py`` does (its control test takes this
cell from the manifest)."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest

from portbench.lib import cell as cells
from portbench.lib import synth
from portbench.tests.conftest import measure, tiny_cell
from portbench.tests.test_pb_reference import train_fault

CELL = "affinity.train.highest"
SEED = 2 ** 31 + 77
FAULTS = ["state_unchanged", "altered_update", "half_batch"]
METRICS = [m["name"] for m in cells.manifest()["per_layer"]
           if m.get("workloads") == [CELL]]
HOST_METRICS = ["wait_batch_ms.affinity_train",
                "batch_produce_ms.affinity_train",
                "h2d_host_ms.affinity_train",
                "backward_host_ms.affinity_train",
                "grid_cells_useful.affinity_train"]
# synth.affinity_images(config, 60, 7) as the predict cell has it: the
# label draw must not move it
IMAGES_DIGEST = ("1d4c0c04fbd092e32be985a93bfb71472a1248de6b6278399a5f604299"
                 "ef7fad")


def _driver():
    return cells.load_module(cells.part("drivers", "affinity_train"))


def _config(name: str = "affinity-flickr30k") -> dict:
    with open(os.path.join(cells.HERE, "configs", name + ".json"),
              encoding="utf-8") as f:
        return json.load(f)


def affinity_fault(fault: str, monkeypatch) -> None:
    """Break the affinity train step underneath `drivers/affinity_train.py`:
    a state left unchanged and an update doubled as the relation cell's
    faults break it, half the batch's cells left out of the loss here."""
    from icl_torch.train import steps

    if fault != "half_batch":
        train_fault(fault, monkeypatch)
        return
    make = steps.make_affinity_train_step

    def halved(*a, **k):
        step = make(*a, **k)

        def f(state, table, batch):
            gv = batch["grid_valid"].clone()
            gv[max(gv.shape[0] // 2, 1):] = False
            return step(state, table, {**batch, "grid_valid": gv})
        return f
    monkeypatch.setattr(steps, "make_affinity_train_step", halved)


@pytest.mark.parametrize("fault", FAULTS)
def test_train_faults_fail(fault, monkeypatch):
    affinity_fault(fault, monkeypatch)
    out = measure(tiny_cell(CELL), SEED, seconds=0.3)
    assert not out["correct"], out["checks"]


def _digest(images: list[dict]) -> str:
    h = hashlib.sha256()
    for im in images:
        h.update(im["img_id"].encode())
        for c in im["captions"]:
            h.update(np.asarray(c, np.int32).tobytes())
        h.update(np.asarray(im["mentions"], np.int64).tobytes())
        for p in im["phrases"]:
            h.update(np.asarray(p, np.int32).tobytes())
        h.update(np.asarray([im["box_row"], im["n_boxes"]],
                            np.int64).tobytes())
    return h.hexdigest()


def test_labels_fixed_per_seed_and_images_unmoved():
    cfg, drv = _config(), _driver()
    images = synth.affinity_images(cfg, 60, 7)
    a, b = drv.draw_labels(images, 7), drv.draw_labels(images, 7)
    c = drv.draw_labels(images, 2 ** 40 + 7)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    for im, grid in zip(images, a):
        assert grid.shape == (len(im["phrases"]), im["n_boxes"])
        assert grid.dtype == np.int32
        assert (grid.sum(1) == 1).all()          # one positive box a phrase
    assert "labels" not in images[0]
    assert _digest(images) == _digest(synth.affinity_images(cfg, 60, 7)) \
        == IMAGES_DIGEST


def test_train_config_keeps_the_model_and_states_the_cells_recipe():
    """The cell's configuration is the predict cell's model and data, every
    number unchanged (nothing cut), and its recipe is the one the cell's
    file runs and the program's Adam takes."""
    import torch
    from icl_torch.models.affinity import AffinityModel
    from icl_torch.train.state import create_train_state

    c = cells.load_cell(CELL)
    train, predict = c["config"], _config()
    assert train == _config(c["entry"]["config"])
    assert train["reduced"] == []
    for k, v in predict.items():
        if isinstance(v, (int, float)):
            assert train[k] == v, k
    assert train["assumed"][:len(predict["assumed"])] == predict["assumed"]
    recipe, spec = train["train"], c["spec"]
    assert (recipe["dropout"], recipe["learn_rate"], recipe["class_weights"]) \
        == (spec["dropout"], spec["learn_rate"], spec["class_weights"])
    model = AffinityModel(emb_dim=3, box_dim=4, lstm_hidden=2, head_hidden=5,
                          num_classes=2, fused=False, device="cpu")
    opt = create_train_state(model, learn_rate=recipe["learn_rate"]).optimizer
    assert isinstance(opt, torch.optim.Adam)
    assert opt.defaults["lr"] == recipe["learn_rate"]
    assert list(opt.defaults["betas"]) == recipe["adam_betas"]
    assert opt.defaults["eps"] == recipe["adam_eps"]


def test_work_counts_tiny():
    work = cells.load_module(cells.part("work", "affinity-flickr30k-train.train"))
    cfg = {"emb_dim": 3, "lstm_hidden": 2, "head_hidden": 5,
           "num_classes": 2, "box_dim": 7}
    gv = np.zeros((1, 3, 4), bool)
    gv[0, :2, :2] = True
    arrays = {"phrase_len": np.array([[2, 1, 0]]),
              "phrase_tokens": np.zeros((1, 3, 4), np.int32),
              "box_valid": np.array([[True, True, False, False]]),
              "grid_valid": gv}
    s = work.stats(arrays, cfg)
    assert s == {"I": 1, "M": 3, "L": 4, "B": 4, "tokens": 3, "phrases": 2,
                 "boxes": 2, "cells": 4}
    proj = 2 * 3 * 2 * 3 * 8             # x W and its weight's gradient
    rec = 3 * 3 * (8 * 4 + 10 * 2)       # forward, dgates . R^T, dR
    phrase = 3 * 2 * 2 * 2 * 5           # h Wp, dh, dWp
    box = 2 * 2 * 2 * 7 * 5              # f Wb, dWb
    head = 2 * 5 + 4 * 5 * 7 + 4 * 6 * 2
    head_bwd = 4 * 5 * 16 + 4 * 8 * 2
    assert work.flops(s, cfg) == proj + rec + phrase + box + head + head_bwd
    # K8: 35 + 140 + 320 + 64 float and 200 hash operations, 520 bytes
    assert work.ght_loss_bwd_bound_s(s, cfg) == pytest.approx(
        max(559 / 67e12, 200 / 16.7e12, 520 / 3.35e12))
    # the backward kernel: one valid step past a row's first, three in all;
    # gates, dgates [4, 3, 8], c, dhs [4, 3, 2], R^T [8, 2], dh [3, 2] in
    # f32 and the mask [4, 3] in bytes
    nbytes = 4 * (2 * 96 + 2 * 24 + 16 + 6) + 12
    assert work.lstm_bwd_bound_s(s, cfg) == pytest.approx(
        max((1 * 8 * 4 + 3 * 20 * 2) / 67e12, nbytes / 3.35e12))


def test_a_traced_run_reports_the_host_metrics():
    out = measure(tiny_cell(CELL), 2 ** 31 + 11, seconds=0.5, trace=True)
    assert out["correct"]
    got = out["metrics"]
    for m in HOST_METRICS:
        assert got[m]["value"] > 0, m
    assert got["grid_cells_useful.affinity_train"]["value"] < 100
    assert got["h2d_host_ms.affinity_train"]["value"] < \
        got["batch_produce_ms.affinity_train"]["value"]


def test_listed_in_the_one_cell_and_moving_train_step_ms():
    assert sorted(METRICS) == sorted(
        HOST_METRICS + ["idle_share.affinity_train", "mfu.affinity_train",
                        "launches_per_step.affinity_train",
                        "lstm_recurrence_bwd_roofline.affinity_train",
                        "ght_loss_bwd_roofline.affinity_train"])
    listed = {m["name"]: m for m in cells.manifest()["per_layer"]}
    assert all(listed[m]["moves"] == "train_step_ms" for m in METRICS)


@pytest.mark.parametrize("snapshot", [None, {"spans": {}, "counters": {
    "batch.box_rows": 8, "batch.box_rows_real": 5}}])
def test_readers_give_none_with_nothing_to_read(snapshot, monkeypatch):
    """No trace, and a program without the grid-cell counters (the
    parent's): every new metric reads None and raises nothing."""
    from portbench.lib import spans

    monkeypatch.setattr(spans, "_take", lambda: snapshot)
    c = cells.load_cell(CELL)
    for m in METRICS:
        run = {"cell": c, "stats": {"stats": [], "steps": 0, "cfg": {}}}
        assert cells.metric_reader(m).read(run) is None, m


@pytest.mark.cuda
@pytest.mark.parametrize("seed", (3141592653, 2718281828, 1618033988))
@pytest.mark.parametrize("fault", FAULTS)
def test_train_fault_fails_on_the_card(fault, seed, cuda_device,
                                       monkeypatch):
    from portbench.tests.test_pb_control import SECONDS, _reading

    affinity_fault(fault, monkeypatch)
    out = measure(cells.load_cell(CELL), seed, SECONDS, device=cuda_device)
    _reading(CELL, fault, seed, out)
    assert not out["correct"], out["checks"]
