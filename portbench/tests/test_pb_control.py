"""The controls and the training faults on the card, at each cell's own
size, on three seeds: each has to come out not correct.  Marked ``cuda``;
skips without a card.  Run on the card:

    python -m pytest -p no:cacheprovider -s portbench/tests/test_pb_control.py

Each run prints ``READING <cell> <what> <seed> <checks>``: the upper
readings the limits in ``workloads/<cell>.json`` are set from.
"""

from __future__ import annotations

import json

import pytest

from portbench.lib import cell as cells
from portbench.tests.conftest import measure
from portbench.tests.test_pb_reference import train_fault

pytestmark = pytest.mark.cuda
SEEDS = (3141592653, 2718281828, 1618033988)
SECONDS = 3.0


def _reading(name, what, seed, out):
    print("READING", name, what, seed, json.dumps(
        {k: c["value"] for k, c in out["checks"].items()}), flush=True)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.manifest()["workloads"]])
def test_control_fails(name, seed, cuda_device):
    out = measure(cells.load_cell(name), seed, SECONDS, device=cuda_device,
                  control=True)
    _reading(name, "control", seed, out)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", ["altered_update", "half_batch"])
def test_train_fault_fails(fault, seed, cuda_device, monkeypatch):
    train_fault(fault, monkeypatch)
    out = measure(cells.load_cell("relation.train.highest"), seed, SECONDS,
                  device=cuda_device)
    _reading("relation.train.highest", fault, seed, out)
    assert not out["correct"], out["checks"]
