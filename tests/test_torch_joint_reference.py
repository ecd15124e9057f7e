"""Joint inference against its plain reference on the CPU, at a small size.

The benchmark's joint cell (``portbench/drivers/joint_predict.py``) builds
the four task models over one split and sweeps them through the task CLIs'
``predict_parts`` and ``icl_torch.cli._predict.predict_in_order``.  Here, on
6 images with LSTM 16, heads 24 and a 50-row table, on seeded random
weights: each of the four sweeps against the plain reference
(``portbench/reference/joint-flickr30k.predict.py``) at 1e-5; and one pass
of the driver over a split written to disk gives the bytes that
``icl-torch-joint --with_cardinality --with_rank`` writes for it.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from icl_torch.cli import _mention_task  # noqa: E402
from icl_torch.cli import affinity as affinity_cli  # noqa: E402
from icl_torch.cli import joint as joint_cli  # noqa: E402
from icl_torch.cli import relation as relation_cli  # noqa: E402
from icl_torch.cli._common import (load_embeddings,  # noqa: E402
                                   precision_policy)
from icl_torch.cli._predict import predict_in_order  # noqa: E402
from icl_torch.data.pipeline import (load_affinity_dataset,  # noqa: E402
                                     load_mention_dataset,
                                     load_relation_dataset)
from icl_torch.params import save_npz  # noqa: E402
from icl_torch.testing.synth import SynthConfig, generate_dataset  # noqa: E402
from portbench.lib import cell, synth  # noqa: E402
from portbench.lib.weights import make_table  # noqa: E402

CPU = torch.device("cpu")
SEED = 2 ** 31 + 26
JOINT = cell.load_module(os.path.join(ROOT, "portbench", "drivers",
                                      "joint_predict.py"))
REF = cell.load_module(os.path.join(ROOT, "portbench", "reference",
                                    "joint-flickr30k.predict.py"))
SMALL = {"vocab_size": 49, "emb_dim": 12, "lstm_hidden": 16,
         "relation_head_hidden": 24, "affinity_head_hidden": 24,
         "mention_hidden": 24, "box_dim": 20}
TRAFFIC = {"images_per_batch": 4, "batch_size": 32}
GATE = 1e-5


def _config(**over) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs",
                           "joint-flickr30k.json")) as f:
        return {**json.load(f), **SMALL, **over}


@pytest.fixture(scope="module")
def split():
    cfg = _config()
    images = JOINT.split(cfg, 6, SEED)
    boxes = synth.box_block(sum(im["n_boxes"] for im in images),
                            cfg["box_dim"], SEED, CPU)
    params = JOINT.weights(cfg, SEED, CPU)
    table = make_table(cfg, SEED, CPU)
    data = JOINT.datasets(cfg, images, boxes)
    job = JOINT.build(cfg, TRAFFIC, params, data, table, CPU,
                      precision_policy("high", "cpu", True))
    return types.SimpleNamespace(cfg=cfg, images=images, boxes=boxes,
                                 params=params, table=table, job=job)


def _sweep(job, task):
    """One task's sweep through its CLI's shared function."""
    model, table, data = job["models"][task], job["table"], job["data"]
    if task == "relation":
        parts = relation_cli.predict_parts(model, table, data[task],
                                           job["relation"])
    elif task == "affinity":
        parts = affinity_cli.predict_parts(model, table, data[task],
                                           job["affinity"], True)
    else:
        parts = _mention_task.predict_parts(model, table, data[task],
                                            job["mentions"][task])
    batches, predict, where, ids = parts
    width = {"relation": 4, "affinity": 3, "nonvisual": 2,
             "cardinality": 12}[task]
    return ids, predict_in_order(batches, CPU, predict, where, ids,
                                 JOINT.UNITS[task], width, task)


@pytest.mark.parametrize("task", JOINT.TASKS)
def test_each_sweep_matches_the_plain_reference(split, task):
    ids, rows = _sweep(split.job, task)
    p, t, images = split.params[task], split.table, split.images
    if task == "relation":
        want = np.concatenate(REF.relation(p, t, images))
    elif task == "affinity":
        want = np.concatenate([np.concatenate(
            [probs.reshape(-1, 2), rank.reshape(-1, 1)], 1)
            for probs, rank in REF.affinity(p, t, images, split.boxes)])
    else:
        want = REF.mention(p, t, [ph for im in images
                                  for ph in im["phrases"]])
    assert rows.shape == want.shape and len(ids) == len(rows) > 0
    assert np.abs(rows - want).max() <= GATE
    if task == "relation":
        assert ids[0].startswith(f"doc:{images[0]['img_id']};caption_1:")


def _files(d: str) -> dict:
    names = [f"dev.{t}.scores" for t in JOINT.TASKS] + ["dev.affinity.rank"]
    out = {}
    for n in names:
        with open(os.path.join(d, n), "rb") as f:
            out[n] = f.read()
    return out


def test_a_pass_writes_the_joint_commands_bytes(tmp_path):
    d = str(tmp_path / "data")
    generate_dataset(d, "dev", SynthConfig(num_images=6, seed=SEED % 1000,
                                           emb_dim=12, vocab_size=40,
                                           max_boxes_per_image=5))
    emb = load_embeddings(types.SimpleNamespace(
        embeddings_file=None, data_dir=d, data_split="dev"))
    data = {"relation": load_relation_dataset(d, "dev", emb),
            "affinity": load_affinity_dataset(d, "dev", emb)}
    for task in JOINT.MENTION_TASKS:
        data[task] = load_mention_dataset(d, "dev", task, emb)
    cfg = _config(emb_dim=emb.dim, box_dim=data["affinity"].box_dim)
    params = JOINT.weights(cfg, SEED, CPU)
    for task in JOINT.TASKS:
        m = JOINT.model_cfg(cfg, task)
        mc = ({"hidden": m["hidden"]} if task in JOINT.MENTION_TASKS else
              {"lstm_hidden": m["lstm_hidden"],
               "head_hidden": m["head_hidden"], "phrase_enc": "lstm"})
        os.makedirs(os.path.join(d, f"{task}.model"))
        save_npz(os.path.join(d, f"{task}.model", f"{task}.npz"),
                 params[task], model_config={"task": task, **mc})
    joint_cli.main(["--predict", "--data_dir", d, "--data_split", "dev",
                    "--device", "cpu", "--fused", "on",
                    "--with_cardinality", "--with_rank"])
    out = str(tmp_path / "pass")
    os.makedirs(out)
    job = JOINT.build(cfg, {"images_per_batch": 8, "batch_size": 512},
                      params, data, torch.from_numpy(emb.table), CPU,
                      precision_policy("high", "cpu", True))
    JOINT.one_pass(job, CPU, types.SimpleNamespace(
        scores_file=None, data_dir=out, data_split="dev"))
    cli, ours = _files(d), _files(out)
    assert all(len(v) > 0 for v in cli.values())
    assert ours == cli
