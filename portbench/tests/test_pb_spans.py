"""The readers of the program's own spans and counters (``lib/spans.py``
and the seven metrics that read it) on the CPU: a traced run of each cell
reports them as numbers, and a program without the tracer, or a run that
recorded nothing, leaves them out without raising."""

from __future__ import annotations

import sys

import pytest

from portbench.lib import cell as cells
from portbench.lib import spans
from portbench.tests.conftest import measure, tiny_cell

NEW = {"affinity.predict": ["h2d_host_ms.affinity_predict",
                            "box_rows_useful.affinity_predict",
                            "batch_produce_ms.affinity_predict"],
       "relation.train.highest": ["forward_host_ms.relation_train",
                                  "backward_host_ms.relation_train",
                                  "recurrence_bwd_host_ms.relation_train",
                                  "optimizer_host_ms.relation_train"]}


@pytest.mark.parametrize("name", sorted(NEW))
def test_a_traced_run_reports_the_program_spans(name):
    out = measure(tiny_cell(name), 2 ** 31 + 11, seconds=0.5, trace=True)
    assert out["correct"]
    got = out["metrics"]
    for m in NEW[name]:
        assert got[m]["value"] > 0, m
    if name == "affinity.predict":
        assert got["box_rows_useful.affinity_predict"]["value"] < 100
    else:
        phases = sum(got[m]["value"] for m in NEW[name]
                     if not m.startswith("recurrence"))
        assert got["recurrence_bwd_host_ms.relation_train"]["value"] <= \
            got["backward_host_ms.relation_train"]["value"] < phases


def test_listed_in_their_one_cell():
    listed = {m["name"]: m["workloads"] for m in cells.manifest()["per_layer"]}
    for cell, names in NEW.items():
        for m in names:
            assert listed[m] == [cell]


@pytest.mark.parametrize("program", ["without the tracer", "nothing kept"])
def test_readers_give_none(monkeypatch, program):
    import icl_torch.util
    from icl_torch.util import trace

    trace.reset()
    if program == "without the tracer":
        monkeypatch.setitem(sys.modules, "icl_torch.util.trace", None)
        monkeypatch.delattr(icl_torch.util, "trace")
        with pytest.raises(ImportError):
            from icl_torch.util import trace  # noqa: F401, F811
    for names in NEW.values():
        for m in names:
            assert cells.metric_reader(m).read({"stats": {}}) is None
    run = {}
    assert spans.of(run) is spans.of(run)
