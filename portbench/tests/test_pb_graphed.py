"""The readers of the train step's CUDA-graph counters: None where the
program kept no ``train.graph.replay`` (no tracer, a program without the
graphed step, a window of eager steps), the share of replayed steps where
it did."""

from __future__ import annotations

import pytest

from portbench.lib import cell as cells
from portbench.lib import spans

NAMES = {"graphed_steps.relation_train": "relation.train.highest",
         "graphed_steps.affinity_train": "affinity.train.highest"}


def _run(counters):
    return {spans.KEY: None if counters is None else
            {"spans": {}, "counters": counters, "events": [], "dropped": 0}}


@pytest.mark.parametrize("name", sorted(NAMES))
@pytest.mark.parametrize("counters", [None, {}, {"train.step": 40}])
def test_reads_none_without_the_counters(name, counters):
    assert cells.metric_reader(name).read(_run(counters)) is None


@pytest.mark.parametrize("name", sorted(NAMES))
def test_reads_the_share_of_replayed_steps(name):
    read = cells.metric_reader(name).read
    assert read(_run({"train.step": 40, "train.graph.replay": 40})) == 100.0
    assert read(_run({"train.step": 40, "train.graph.replay": 30})) == 75.0


def test_listed_in_their_one_cell():
    listed = {m["name"]: m for m in cells.manifest()["per_layer"]}
    for name, cell in NAMES.items():
        assert listed[name]["workloads"] == [cell]
        assert listed[name]["moves"] == "train_step_ms"
        assert listed[name]["source"] == "program_counter"
