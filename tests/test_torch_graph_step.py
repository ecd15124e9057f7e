"""The image train step as one CUDA graph per batch key
(``icl_torch/train/graphs.py``).

On the CPU: the key, the rule that takes a call to the graphs, that a
CPU step and a step under a process group run the eager step (no graph
counter, the eager step's results), that a checkpoint of a state that ran
the graphs resumes on the CPU, and that every kernel's launch counter is
named where the card's cases read them.  Marked ``cuda`` and skipped without a
card: the graphed step against the eager step from one state over keys A,
B, A, C, B, with the same launch counts; a checkpoint saved after graphed
steps resumes; a capture that fails leaves its key eager, counted.  The
cases import no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph_step.py
"""

from __future__ import annotations

import copy
import inspect
import logging
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

from icl_torch import ops
from icl_torch.dist.mesh import Mesh
from icl_torch.models.affinity import AffinityModel
from icl_torch.models.relation import RelationModel
from icl_torch.params import init_params
from icl_torch.train import graphs, steps
from icl_torch.train.checkpoint import (Checkpointer, load_into, snapshot,
                                        to_host)
from icl_torch.train.state import create_train_state
from icl_torch.util import trace

SMALL = {"relation": {"emb_dim": 12, "lstm_hidden": 8, "head_hidden": 16},
         "affinity": {"emb_dim": 12, "box_dim": 20, "lstm_hidden": 8,
                      "head_hidden": 16}}
FULL = {"relation": {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 800},
        "affinity": {"emb_dim": 300, "box_dim": 4096, "lstm_hidden": 200,
                     "head_hidden": 1024}}
CW = {"relation": [0.3, 1.0, 1.0, 1.0], "relation_pair": [0.0, 1.0, 1.0, 1.0],
      "affinity": None}
# (images, tokens a caption or phrase, mentions, boxes) of keys A, B, C
KEYS = {"A": (4, 16, 8, 32), "B": (4, 32, 8, 16), "C": (2, 16, 16, 32)}
ORDER = "ABACB"


def _relation_batch(I, L, M, seed, dev):
    g = torch.Generator().manual_seed(seed)
    C = 5
    iu, ju = torch.triu_indices(M, M, 1)
    P = iu.numel()
    label = torch.randint(0, 4, (I, P), generator=g)
    valid = torch.rand(I, P, generator=g) < 0.9
    glabel = torch.zeros(I, M, M, dtype=torch.int32)
    gvalid = torch.zeros(I, M, M, dtype=torch.bool)
    glabel[:, iu, ju] = label.to(torch.int32)
    gvalid[:, iu, ju] = valid
    batch = {"tokens": torch.randint(1, 100, (I, C, L), generator=g),
             "tok_len": torch.randint(0, L + 1, (I, C), generator=g),
             "m_cap": torch.randint(0, C, (I, M), generator=g),
             "m_first": torch.randint(0, L // 2, (I, M), generator=g),
             "m_last": torch.randint(L // 2, L, (I, M), generator=g),
             "pair_ij": torch.stack([iu, ju], 1).expand(I, P, 2),
             "pair_label": label, "pair_valid": valid,
             "grid_label": glabel, "grid_valid": gvalid}
    return {k: v.contiguous().to(dev) for k, v in batch.items()}


def _affinity_batch(I, L, M, B, seed, dev, box_dim):
    g = torch.Generator().manual_seed(seed)
    plen = torch.randint(0, L // 2 + 1, (I, M), generator=g)
    box_valid = torch.arange(B)[None] < torch.randint(0, B + 1, (I, 1),
                                                      generator=g)
    batch = {"phrase_tokens": torch.randint(1, 100, (I, M, L), generator=g),
             "phrase_len": plen.to(torch.int32),
             "box_feats": torch.relu(torch.randn(I, B, box_dim,
                                                 generator=g)),
             "box_valid": box_valid,
             "grid_label": torch.randint(0, 2, (I, M, B), generator=g),
             "grid_valid": (plen > 0)[..., None] & box_valid[:, None, :]}
    return {k: v.contiguous().to(dev) for k, v in batch.items()}


def _setup(case, dims, dev, keys=KEYS):
    """A model, a word table and one batch a key."""
    task = "affinity" if case == "affinity" else "relation"
    if task == "relation":
        model = RelationModel(**dims, fused=True, dropout=0.5, device=dev)
        batches = {k: _relation_batch(I, L, M, 10 + n, dev)
                   for n, (k, (I, L, M, _)) in enumerate(keys.items())}
    else:
        model = AffinityModel(**dims, fused=True, dropout=0.5, device=dev)
        batches = {k: _affinity_batch(I, L, M, B, 10 + n, dev,
                                      dims["box_dim"])
                   for n, (k, (I, L, M, B)) in enumerate(keys.items())}
    g = torch.Generator().manual_seed(3)
    table = torch.randn(100, dims["emb_dim"], generator=g).to(dev)
    return task, model, init_params(task, 0, model.dims), table, batches


def _maker(case):
    task = "affinity" if case == "affinity" else "relation"
    make = (steps.make_affinity_train_step if task == "affinity"
            else steps.make_relation_train_step)
    return lambda mesh=None: make(class_weights=CW[case], grid_loss=True,
                                  mesh=mesh)


def _eager_step(case, state, table, batch):
    """The eager step written out: the task's loss, backward, Adam."""
    loss_fn = (steps.affinity_loss if case == "affinity"
               else steps.relation_loss)
    images = batch["phrase_tokens" if case == "affinity" else "tokens"]
    cw = (None if CW[case] is None
          else torch.tensor(CW[case], device=table.device))
    grid_loss = CW[case] is None or min(CW[case]) > 0
    state.optimizer.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(state.model, table, batch,
                            state.dropout_seeds(images.shape[0]), cw,
                            grid_loss)
    loss.backward()
    state.apply_gradients()
    return {k: v.detach() for k, v in metrics.items()}


def _profiled(fn):
    """``fn()`` under a profile: (its result, the counters kept)."""
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    counters = trace.snapshot()["counters"]
    trace.reset()
    return out, counters


# --- the CPU ------------------------------------------------------------------

def test_batch_key_names_what_a_capture_fixes():
    _, _, _, table, b = _setup("relation", SMALL["relation"], "cpu")
    key = graphs.batch_key(table, b["A"])
    again = {k: v.clone() for k, v in b["A"].items()}
    assert graphs.batch_key(table, again) == key      # values do not count
    assert graphs.batch_key(table, b["B"]) != key     # shapes do
    cast = {**b["A"], "tok_len": b["A"]["tok_len"].int()}
    assert graphs.batch_key(table, cast) != key       # dtypes do
    assert graphs.batch_key(table.clone(), b["A"]) != key   # where it lies


def test_graphable_wants_a_cuda_table():
    from torch._subclasses.fake_tensor import FakeTensorMode

    assert not graphs.graphable(torch.zeros(4, 2))
    with FakeTensorMode():
        assert graphs.graphable(torch.zeros(4, 2, device="cuda"))


@pytest.mark.parametrize("case", ["relation", "relation_pair", "affinity"])
def test_a_cpu_step_runs_the_eager_step(case):
    """No graph counter, and the eager step's bits."""
    got, want = {}, {}
    for side in ("step", "eager"):
        _, model, flat, table, batches = _setup(
            case, SMALL[case.split("_")[0]], "cpu")
        state = create_train_state(model, seed=7, params=flat)
        step = _maker(case)()

        def run(state=state, step=step, side=side):
            return [(step(state, table, batches[k]) if side == "step" else
                     _eager_step(case, state, table, batches[k]))
                    for k in ORDER]

        (metrics, counters) = _profiled(run)
        (got if side == "step" else want).update(
            metrics=metrics, counters=counters,
            state=state.named_tensors(),
            grads={n: p.grad for n, p in model.named_parameters()})
    assert got["counters"]["train.step"] == len(ORDER)
    assert not any(k.startswith("train.graph") for k in got["counters"])
    for m_got, m_want in zip(got["metrics"], want["metrics"]):
        assert m_got.keys() == m_want.keys()
        assert all(torch.equal(m_got[k], m_want[k]) for k in m_got)
    for part in ("state", "grads"):
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            assert torch.equal(got[part][k], v), (part, k)


def test_a_step_under_a_process_group_runs_the_eager_step(tmp_path,
                                                          monkeypatch):
    """With a process group up the graphs are never asked, even for a call
    they would take (a world of one over gloo; ``graphable`` forced)."""
    monkeypatch.setattr(graphs, "graphable", lambda table: True)

    def refuse(*args):
        raise AssertionError("the graphed step was asked under a mesh")

    monkeypatch.setattr(graphs.GraphedStep, "__call__", refuse)
    _, model, flat, table, batches = _setup("relation", SMALL["relation"],
                                            "cpu")
    ref_model = RelationModel(**SMALL["relation"], fused=True, dropout=0.5)
    ref = create_train_state(ref_model, seed=7, params=flat)
    state = create_train_state(model, seed=7, params=flat)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        step = _maker("relation")(Mesh(data=1, model=1, rank=0, world=1))
        metrics, counters = _profiled(
            lambda: [step(state, table, batches[k]) for k in ORDER])
    finally:
        dist.destroy_process_group()
    assert counters["train.step"] == len(ORDER)
    assert not any(k.startswith("train.graph") for k in counters)
    want = [_eager_step("relation", ref, table, batches[k]) for k in ORDER]
    for m_got, m_want in zip(metrics, want):
        assert torch.allclose(m_got["loss"], m_want["loss"], rtol=1e-6)
    for k, v in ref.named_tensors().items():
        assert torch.allclose(state.named_tensors()[k], v, rtol=1e-6,
                              atol=1e-7), k


@pytest.mark.parametrize("case", ["relation", "affinity"])
def test_a_checkpoint_of_the_graphs_resumes_on_the_cpu(case):
    """A payload whose Adam groups say ``capturable`` (saved by a state
    that ran the graphs on the card) restores into a CPU state, which
    keeps its own mode and steps as from the same payload saved eagerly."""
    _, model, flat, table, batches = _setup(case, SMALL[case], "cpu")
    state = create_train_state(model, seed=7, params=flat)
    step = _maker(case)()
    step(state, table, batches["A"])
    payload = {**to_host(snapshot(state)), "step": state.step,
               "seed": state.seed}
    opt = payload["optimizer"]
    card = {**payload, "optimizer": {**opt, "param_groups": [
        {**g, "capturable": True} for g in opt["param_groups"]]}}
    out = []
    for saved in (payload, card):
        resumed = create_train_state(_setup(case, SMALL[case], "cpu")[1],
                                     seed=0, params=flat)
        load_into(resumed, copy.deepcopy(saved))   # CPU tensors load shared
        assert not any(g["capturable"]
                       for g in resumed.optimizer.param_groups)
        step = _maker(case)()
        metrics = [step(resumed, table, batches[k]) for k in "BA"]
        out.append((metrics, resumed.named_tensors()))
    (m_eager, s_eager), (m_card, s_card) = out
    for got, want in zip(m_card, m_eager):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert s_card.keys() == s_eager.keys()
    for k, v in s_eager.items():
        assert torch.equal(s_card[k], v), k


def test_every_kernel_launch_counter_is_named():
    """Each wrapper's ``launches`` (and ``mma_launches``) lies in
    ``ops.launch_counters()``, which the card's cases compare between the
    graphed and the eager step."""
    from icl_torch.ops import (affinity_rank, grid_head, grid_head_train,
                               lstm_recurrence)

    found = set()
    for mod in (affinity_rank, grid_head, grid_head_train, lstm_recurrence):
        for _, fn in inspect.getmembers(mod, callable):
            if getattr(fn, "__module__", None) == mod.__name__ and hasattr(
                    fn, "launches"):
                found.add(id(fn))
                found |= {id(v) for v in vars(fn).values()
                          if isinstance(v, SimpleNamespace)}
    named = {id(c) for c in ops.launch_counters().values()}
    assert len(found) == 16 and found == named


# --- the card -------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, what):
    tol = 1e-6 * max(want.abs().max().item(), 1e-30)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (what, err, tol)


def _launches():
    return [getattr(c, attr) for c in ops.launch_counters().values()
            for attr in ("launches", "mma_launches") if hasattr(c, attr)]




@pytest.mark.cuda
@pytest.mark.parametrize("case", ["relation", "relation_pair", "affinity"])
def test_graphed_step_matches_the_eager_step(dev, case):
    """Keys A, B, A, C, B from one state: the graphed step (eager first,
    three captures, four replays) against the eager step, f32 exact:
    losses, parameters, Adam's moments and ``.grad`` within 1e-6 relative;
    the same launch counts and ``lstm.bwd.kernel``; fresh metrics."""
    out = {}
    for side in ("graphed", "eager"):
        _, model, flat, table, batches = _setup(
            case, FULL[case.split("_")[0]], dev)
        state = create_train_state(model, seed=7, params=flat)
        step = _maker(case)()
        n0 = _launches()

        def run(state=state, step=step, side=side):
            got = []
            for n, k in enumerate(ORDER):
                if side == "graphed":
                    m = step(state, table, batches[k])
                else:
                    m = _eager_step(case, state, table, batches[k])
                    if n == 0:      # Adam in the graphs' mode from step 2
                        graphs.make_capturable(state.optimizer)
                got.append({n: v.clone() for n, v in m.items()})
                got[-1]["held"] = m
            torch.cuda.synchronize()
            return got

        metrics, counters = _profiled(run)
        out[side] = dict(
            metrics=metrics, counters=counters,
            launches=[a - b for a, b in zip(_launches(), n0)],
            state=state.named_tensors(), step=state.step,
            grads={n: p.grad for n, p in model.named_parameters()})
    g, e = out["graphed"], out["eager"]
    assert g["counters"].get("train.graph.capture") == 3
    assert g["counters"].get("train.graph.replay") == 4
    assert "train.graph.fallback" not in g["counters"]
    assert g["launches"] == e["launches"]
    assert (g["counters"].get("lstm.bwd.kernel")
            == e["counters"].get("lstm.bwd.kernel") == len(ORDER))
    assert g["step"] == e["step"] == len(ORDER)
    for m_got, m_want in zip(g["metrics"], e["metrics"]):
        for k in m_want:
            if k != "held":
                _close(m_got[k], m_want[k], k)
                # a metric returned earlier is not overwritten by later steps
                assert torch.equal(m_got["held"][k], m_got[k])
    assert g["state"].keys() == e["state"].keys()
    for k, v in e["state"].items():
        _close(g["state"][k], v, k)
    for k, v in e["grads"].items():
        _close(g["grads"][k], v, f"grad {k}")


@pytest.mark.cuda
def test_a_checkpoint_after_graphed_steps_resumes(dev, tmp_path):
    """Saved after graphed steps (a background pull each step, on a stream
    of its own): Adam's ``step`` as an eager run keeps it; restored into a
    new state, the next steps land where the first state's do, bit for
    bit."""
    _, model, flat, table, batches = _setup("relation", FULL["relation"], dev)
    state = create_train_state(model, seed=7, params=flat)
    step = _maker("relation")()
    ckpt = Checkpointer(str(tmp_path / "every"), max_to_keep=1)
    for n, k in enumerate(ORDER):
        step(state, table, batches[k])
        ckpt.save(state, epoch=0, batch_in_epoch=n + 1)
    ckpt.close()
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(state, wait=True, epoch=0, batch_in_epoch=len(ORDER))
    ckpt.close()
    # the captures' stream is none that the default pool hands out (a
    # checkpoint's pull takes one of those on its own thread)
    pool = {torch.cuda.Stream(dev).cuda_stream for _ in range(64)}
    assert step.graphed._on.stream.cuda_stream not in pool
    names = state.named_tensors()
    adam_steps = [k for k in names if k.startswith("adam/")
                  and k.endswith("/step")]
    assert adam_steps and all(float(names[k]) == len(ORDER)
                              for k in adam_steps)

    model2 = RelationModel(**FULL["relation"], fused=True, dropout=0.5,
                           device=dev)
    resumed = create_train_state(model2, seed=7, params=flat)
    resumed, _, _ = Checkpointer(str(tmp_path)).restore_with_position(resumed)
    assert resumed.step == state.step
    assert resumed.named_tensors().keys() == names.keys()
    for k, v in names.items():
        assert torch.equal(resumed.named_tensors()[k].cpu(), v.cpu()), k
    step2 = _maker("relation")()
    for k in "AB":
        step(state, table, batches[k])
        step2(resumed, table, batches[k])
    # the resumed state's first step, eager, in Adam's mode of the graphs
    for k, v in state.named_tensors().items():
        assert torch.equal(resumed.named_tensors()[k], v), k


@pytest.mark.cuda
def test_a_failed_capture_leaves_its_key_eager(dev, monkeypatch):
    """A loss that reads the device on the host cannot be captured: its
    key runs eagerly from then on, logged and counted once, and the steps
    are the eager step's."""
    def syncing(*args, **kw):
        loss, metrics = loss_fn(*args, **kw)
        float(loss)
        return loss, metrics

    loss_fn = steps.relation_loss
    monkeypatch.setattr(steps, "relation_loss", syncing)
    _, model, flat, table, batches = _setup("relation", FULL["relation"], dev)
    state = create_train_state(model, seed=7, params=flat)
    step = _maker("relation")()
    ref = create_train_state(
        RelationModel(**FULL["relation"], fused=True, dropout=0.5,
                      device=dev), seed=7, params=flat)
    said = []
    log = logging.getLogger("icl")        # icl_torch.util.log's logger
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: said.append(record.getMessage())
    log.addHandler(handler)
    try:
        got, counters = _profiled(
            lambda: [step(state, table, batches[k]) for k in "AAA"])
    finally:
        log.removeHandler(handler)
    want = [_eager_step("relation", ref, table, batches["A"])]
    graphs.make_capturable(ref.optimizer)
    want += [_eager_step("relation", ref, table, batches["A"])
             for _ in range(2)]
    assert counters.get("train.graph.fallback") == 1
    assert "train.graph.replay" not in counters
    assert sum("stays eager" in line for line in said) == 1
    for m_got, m_want in zip(got, want):
        _close(m_got["loss"], m_want["loss"], "loss")
    for k, v in ref.named_tensors().items():
        _close(state.named_tensors()[k], v, k)


@pytest.mark.cuda
def test_captures_under_a_profile_of_the_card(dev, tmp_path):
    """``--profile_dir``'s profile (the card's activity traced too) open
    across the captures: every key captured, every later step replayed, the
    counters in the spans file."""
    import json
    import os

    from icl_torch.train.loop import profile_trace

    _, model, flat, table, batches = _setup("relation", FULL["relation"], dev)
    state = create_train_state(model, seed=7, params=flat)
    step = _maker("relation")()
    with profile_trace(str(tmp_path)):
        for k in ORDER:
            step(state, table, batches[k])
        torch.cuda.synchronize()
    with open(tmp_path / f"spans_{os.getpid()}.jsonl") as f:
        counters = json.loads(f.readlines()[-1])["counters"]
    assert counters.get("train.graph.capture") == 3
    assert counters.get("train.graph.replay") == 4
    assert "train.graph.fallback" not in counters
    assert os.path.exists(tmp_path / f"trace_{os.getpid()}.json")
