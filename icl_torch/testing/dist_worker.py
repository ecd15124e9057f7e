"""One rank of a multi-process check of :mod:`icl_torch.dist` (not a test
module; the tests spawn it, and :func:`run_case` also serves them in
process as the one-process run).

Usage::

    python -m icl_torch.testing.dist_worker steps  RANK WORLD PORT DIR MESH [DEVICE]
    python -m icl_torch.testing.dist_worker gather RANK WORLD PORT DIR
    python -m icl_torch.testing.dist_worker init   RANK WORLD PORT MESH

``steps``: ``DIR/cases.json`` lists train-step cases, each with its inputs
in ``DIR/<name>.npz`` (``table``, ``batch/<key>`` whole global arrays,
``param/<key>`` weights).  Every rank cuts its rows, runs the case's steps
through the data-parallel train step and writes ``DIR/<name>.rank<k>.npz``
(the weights, the last step's gradients, and the loss and accuracy of every
step); then it checks the runtime's re-entry rules and the sharded
``.scores`` write.  ``DEVICE``: ``cpu`` (the default, over gloo) or ``cuda``
(the GPU check: ranks that share a card still sum over gloo).  ``gather``:
:func:`icl_torch.dist.mesh.gather_parts` in its three outcomes, one after
the other in one process group; prints one JSON line a mode.  ``init``:
``runtime.init`` with a mesh that may not cover the ranks; exits 7 with the
message when it raises ``ValueError``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from icl_torch import runtime
from icl_torch.dist.mesh import Mesh, gather_parts, replicate, shard_batch
from icl_torch.io.scores import _write_rows, write_scores_sharded
from icl_torch.models.affinity import AffinityModel
from icl_torch.models.cardinality import CardinalityModel
from icl_torch.models.nonvisual import NonvisualModel
from icl_torch.models.relation import RelationModel
from icl_torch.train.state import create_train_state
from icl_torch.train.steps import (_cell_weights, affinity_loss,
                                   make_affinity_train_step,
                                   make_mention_train_step,
                                   make_relation_train_step, relation_loss)

MENTION_KEYS = ("token_ids", "lengths", "labels", "valid")
MODELS = {"relation": RelationModel, "affinity": AffinityModel,
          "nonvisual": NonvisualModel, "cardinality": CardinalityModel}


def run_case(directory: str, case: dict, mesh: Mesh | None,
             device: str = "cpu", split: int = 1) -> dict:
    """Run one train-step case; ``mesh`` None: the one-process step over
    the whole batch, or, with ``split`` > 1, over that many row blocks one
    after the other (:func:`split_step`).  Returns the weights
    (``param/<key>``), the last step's gradients (``grad/<key>``) and the
    ``loss`` and ``acc`` of every step, as numpy."""
    device = torch.device(device)
    data = np.load(os.path.join(directory, case["name"] + ".npz"))
    table = torch.from_numpy(data["table"]).to(device)
    batch = {k[6:]: data[k] for k in data.files if k.startswith("batch/")}
    params = {k[6:]: data[k].copy() for k in data.files
              if k.startswith("param/")}
    model = MODELS[case["task"]](**case["model"], device=device)
    state = create_train_state(model, seed=case["seed"],
                               learn_rate=case.get("learn_rate", 1e-3),
                               params=params)
    if case["task"] in ("nonvisual", "cardinality"):
        step = make_mention_train_step(mesh=mesh)
        host = tuple(batch[k] for k in MENTION_KEYS)
        args = (shard_batch(host, mesh, device) if mesh is not None else
                tuple(torch.from_numpy(a).to(device) for a in host))
    else:
        make = (make_relation_train_step if case["task"] == "relation"
                else make_affinity_train_step)
        step = make(class_weights=case.get("class_weights"),
                    grid_loss=case["grid_loss"], mesh=mesh)
        args = (shard_batch(batch, mesh, device) if mesh is not None else
                {k: torch.from_numpy(v).to(device)
                 for k, v in batch.items()},)
        if mesh is None and split > 1:
            whole, args = args[0], ()

            def step(state, table):
                return split_step(case, state, table, whole, split)
    losses, accs = [], []
    for _ in range(case["steps"]):
        metrics = step(state, table, *args)
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["acc"]))
    out = {f"param/{k}": v.detach().cpu().numpy()
           for k, v in model.flat_params().items()}
    out.update({"grad/" + k.replace(".", "/"): p.grad.cpu().numpy()
                for k, p in model.named_parameters()})
    out.update(loss=np.asarray(losses), acc=np.asarray(accs))
    return out


def split_step(case: dict, state, table, batch: dict, blocks: int) -> dict:
    """One grid-loss train step of an image task by ONE process that runs
    the batch as ``blocks`` row blocks, one call each, as that many ranks
    would: every block's loss over the global weight sum, the gradients
    accumulated, one Adam update.  The ranks' arithmetic without their
    collectives: each call has a rank's shapes, so a library that rounds by
    shape (cuBLAS picks its kernel by the row count) rounds as it does for
    the ranks."""
    if not case["grid_loss"]:
        raise ValueError("split_step runs the grid-loss form")
    loss_fn, key = ((relation_loss, "tokens") if case["task"] == "relation"
                    else (affinity_loss, "phrase_tokens"))
    cw = case.get("class_weights")
    cw = None if cw is None else torch.tensor(cw, device=table.device)
    rows = batch[key].shape[0]
    per = rows // blocks
    seeds = state.dropout_seeds(rows)
    weights = _cell_weights(batch["grid_label"].to(torch.int32),
                            batch["grid_valid"], cw).sum((1, 2))   # an image
    total = torch.clamp_min(weights.sum(), 1.0)
    state.optimizer.zero_grad(set_to_none=True)
    loss_sum = hits = nvalid = 0.0
    for lo in range(0, rows, per):
        block = {k: v[lo:lo + per] for k, v in batch.items()}
        loss, metrics = loss_fn(state.model, table, block, seeds[lo:lo + per],
                                cw, True)
        share = torch.clamp_min(weights[lo:lo + per].sum(), 1.0) / total
        (loss * share).backward()
        loss_sum = loss_sum + loss.detach() * share
        hits, nvalid = hits + metrics["hits"], nvalid + metrics["nvalid"]
    state.apply_gradients()
    return {"loss": loss_sum, "acc": hits / torch.clamp_min(nvalid, 1.0)}


def _init(rank: int, world: int, port: str, topology: str | None,
          device: str = "cpu"):
    return runtime.init(topology, seed=0, coordinator=f"localhost:{port}",
                        num_processes=world, process_id=rank, device=device)


def _steps(rank: int, world: int, port: str, directory: str,
           topology: str, device: str = "cpu") -> None:
    rt = _init(rank, world, port, topology, device)
    with open(os.path.join(directory, "cases.json")) as f:
        cases = json.load(f)
    for case in cases:
        out = run_case(directory, case, rt.mesh, str(rt.device))
        np.savez(os.path.join(directory, f"{case['name']}.rank{rank}.npz"),
                 **out)
    # the re-entry rules: the same bootstrap is reused, another one raises
    again = _init(rank, world, port, topology, device)
    assert again.mesh == rt.mesh and again.backend == rt.backend == "gloo"
    for kw in ({"num_processes": world + 1}, {"process_id": rank + 1},
               {"coordinator": "localhost:1"}):
        call = dict(coordinator=f"localhost:{port}", num_processes=world,
                    process_id=rank, device=device)
        call.update(kw)
        try:
            runtime.init(topology, **call)
        except ValueError as e:
            assert "conflicting" in str(e), e
        else:
            raise AssertionError(f"a conflicting re-entry passed: {kw}")
    # replicate: rounding apart, every rank takes rank 0's values; a rank
    # whose tensors differ by more stops every rank
    replicate([torch.ones(3)], rt.mesh, "equal tensors")
    noisy = torch.full((3,), 1.0 + 2.0 ** -23 * min(rank, 1))
    replicate([noisy], rt.mesh, "tensors a rounding apart")
    assert torch.equal(noisy, torch.ones(3)), noisy
    try:
        replicate([torch.full((3,), float(min(rank, 1)))], rt.mesh, "a "
                  "diverged state")
    except RuntimeError as e:
        assert f"rank(s) {list(range(1, world))}" in str(e), e
    else:
        raise AssertionError("replicate passed a diverged state")
    # the sharded .scores write: the merged bytes are the parts', in order
    rng = np.random.default_rng(5)
    n = 11
    ids = [f"id{i}" for i in range(n)]
    probs = rng.random((n, 3))
    cuts = np.linspace(0, n, world + 1).astype(int)
    cuts[1] = cuts[0]                       # rank 0's slice is empty
    lo, hi = cuts[rank], cuts[rank + 1]
    path = os.path.join(directory, "sharded.scores")
    _write_rows(f"{path}.own{rank}", ids[lo:hi], probs[lo:hi])
    write_scores_sharded(path, ids[lo:hi], probs[lo:hi], num_classes=3,
                         total_examples=n, class_order=["a", "b", "c"],
                         meta={"task": "check"})
    print(f"worker {rank}/{world}: OK", flush=True)


def _gather(rank: int, world: int, port: str, directory: str) -> None:
    _init(rank, world, port, None)
    for mode in ("fail", "failwrite", "ok"):
        path = os.path.join(directory, mode, "merged.out")
        if rank == 0:
            os.makedirs(os.path.dirname(path), exist_ok=True)

        def write_part(part_path):
            if mode == "failwrite" and rank == 1:
                raise OSError("injected part-write failure")
            os.makedirs(os.path.dirname(part_path), exist_ok=True)
            with open(part_path, "w") as f:
                f.write(f"rank {rank} payload\n")

        def merge(parts):
            if mode == "fail":
                raise OSError("injected merge failure")
            with open(path, "wb") as f:
                for p in parts:
                    with open(p, "rb") as pf:
                        f.write(pf.read())
            return path

        try:
            got = gather_parts(path, "part", write_part, merge)
            said = {"outcome": "ok", "result": got}
        except OSError as e:
            said = {"outcome": "own error", "message": str(e)}
        except RuntimeError as e:
            said = {"outcome": "peer failure", "message": str(e)}
        print(json.dumps({"mode": mode, "rank": rank, **said}), flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    what, rank, world, port = argv[0], int(argv[1]), int(argv[2]), argv[3]
    if what == "steps":
        _steps(rank, world, port, argv[4], *argv[5:7])
    elif what == "gather":
        _gather(rank, world, port, argv[4])
    elif what == "init":
        try:
            _init(rank, world, port, argv[4])
        except ValueError as e:
            print("MESH-CHECK:", e, flush=True)
            sys.exit(7)
        print("unexpectedly initialized", flush=True)
    else:
        raise SystemExit(f"unknown mode {what!r}")


if __name__ == "__main__":
    main()
