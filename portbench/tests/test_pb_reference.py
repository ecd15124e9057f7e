"""The plain references against the port, at a tiny size on the CPU,
through the cells' own drivers: every cell's run comes out correct, and
comes out not correct with its timed path broken underneath, once for each
fault the cell can have (an answer altered where it is produced; half the
batch left out and the mean of the rest in its place; for training also a
step that leaves the state unchanged).  The exchange between chips has no
fault here: every cell runs on one chip."""

from __future__ import annotations

import pytest

from portbench.lib import cell as cells
from portbench.tests.conftest import measure, tiny_cell

SEED = 2 ** 31 + 77
CELLS = [w["name"] for w in cells.manifest()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_port_matches_reference(name):
    out = measure(tiny_cell(name), SEED, seconds=0.5)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def _altered(fn):
    def f(*a, **k):
        out = fn(*a, **k)
        first = out[0] if isinstance(out, tuple) else out
        first = first.clone()
        first.reshape(-1, first.shape[-1])[0, 0] += 0.01
        return (first, *out[1:]) if isinstance(out, tuple) else first
    return f


def _half(fn):
    def fill(t):
        h = max(t.shape[0] // 2, 1)
        t = t.clone()
        t[h:] = t[:h].mean(0)
        return t

    def f(*a, **k):
        out = fn(*a, **k)
        return tuple(map(fill, out)) if isinstance(out, tuple) else fill(out)
    return f


@pytest.mark.parametrize("fault", [_altered, _half])
def test_predict_faults_fail(fault, monkeypatch):
    from icl_torch.train import steps

    monkeypatch.setattr(steps, "affinity_predict",
                        fault(steps.affinity_predict))
    out = measure(tiny_cell("affinity.predict"), SEED, seconds=0.3)
    assert not out["correct"], out["checks"]


def train_fault(fault: str, monkeypatch) -> None:
    """Break the relation train step underneath `drivers/relation_train.py`."""
    from icl_torch.train import state as state_mod
    from icl_torch.train import steps

    if fault == "state_unchanged":
        monkeypatch.setattr(state_mod.TrainState, "apply_gradients",
                            lambda self: setattr(self, "step", self.step + 1))
    elif fault == "altered_update":
        apply = state_mod.TrainState.apply_gradients

        def doubled(self):
            self.model.head_out.bias.grad.mul_(2.0)
            apply(self)
        monkeypatch.setattr(state_mod.TrainState, "apply_gradients", doubled)
    elif fault == "half_batch":
        make = steps.make_relation_train_step

        def halved(*a, **k):
            step = make(*a, **k)

            def f(state, table, batch):
                gv = batch["grid_valid"].clone()
                gv[max(gv.shape[0] // 2, 1):] = False
                return step(state, table, {**batch, "grid_valid": gv})
            return f
        monkeypatch.setattr(steps, "make_relation_train_step", halved)


@pytest.mark.parametrize("fault", ["state_unchanged", "altered_update",
                                   "half_batch"])
def test_train_faults_fail(fault, monkeypatch):
    train_fault(fault, monkeypatch)
    out = measure(tiny_cell("relation.train.highest"), SEED,
                  seconds=0.3)
    assert not out["correct"], out["checks"]
