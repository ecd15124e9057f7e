"""icl_torch.dist and icl_torch.runtime: the mesh arithmetic against the JAX
package, and real ``torch.distributed`` ranks (CPU, gloo) against one
process of the port and against the JAX package's train steps.

Spawned ranks run ``python -m icl_torch.testing.dist_worker`` over
``tcp://localhost:<free port>`` with a 60 s process-group timeout and a
bounded ``communicate``, so a hung rendezvous fails one test.  One spawned
group serves many assertions (module fixtures).  Tolerances:

* ranks against each other: equal bits (every rank ends a sum with the
  same buffer, then runs the same Adam);
* ranks against one process of the port, dropout 0.5, 3-5 steps: 1e-6
  absolute (the sums over the batch associate differently, nothing else);
* ranks against the JAX package's step from the same weights, dropout 0,
  3 steps: 1e-5 * max(1, max |jax|), the port's parity gate;
* the mesh arithmetic (``predict_partition``, ``local_data_rows``,
  ``build_mesh``) against the JAX package: equal integers, equal messages.
"""

import json
import os
import socket
import stat
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl.cli.export import flatten_params
from icl.data.imagebatch import RelationBatcher
from icl.data.pipeline import load_relation_dataset
from icl.dist import mesh as jmesh
from icl.models import AffinityModel as JaxAffinityModel
from icl.models import NonvisualModel as JaxNonvisualModel
from icl.models import RelationModel as JaxRelationModel
from icl.train import steps as jax_steps
from icl.train.state import create_train_state as jax_create_train_state
from icl_torch import runtime
from icl_torch.dist import mesh as tmesh
from icl_torch.io.scores import write_scores
from icl_torch.testing import dist_worker
from icl_torch.train.state import create_train_state
from icl_torch.models.nonvisual import NonvisualModel

from test_torch_affinity import BOX_D, EMB_D, HEAD_H, LSTM_H, affinity_batch
from test_torch_affinity import _table as affinity_table
from test_torch_mention import D as MENTION_D
from test_torch_mention import HIDDEN as MENTION_H
from test_torch_mention import _batch as mention_batch
from test_torch_mention import _table as mention_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS_GATE = 1e-6      # ranks vs one process of the port, absolute
JAX_GATE = 1e-5        # vs the JAX package, relative to max(1, max |jax|)
REL_H, REL_HEAD = 8, 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(what: str, world: int, *args, timeout=240):
    """``world`` ranks of the worker; [(returncode, output)] in rank order."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, ICL_TORCH_DIST_TIMEOUT="60",
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "icl_torch.testing.dist_worker", what,
         str(rank), str(world), port, *map(str, args)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    return [(p.returncode, out) for p, out in zip(procs, outs)]


# --- the mesh arithmetic against the JAX package ---------------------------

def _as_process(monkeypatch, p: int, k: int) -> None:
    """Both packages believe they are process ``k`` of ``p``."""
    monkeypatch.setattr(jax, "process_count", lambda: p)
    monkeypatch.setattr(jax, "process_index", lambda: k)
    monkeypatch.setattr(tmesh, "process_count", lambda: p)
    monkeypatch.setattr(tmesh, "process_index", lambda: k)


@pytest.mark.parametrize("p", [1, 2, 4, 7])
def test_predict_partition_matches_jax(monkeypatch, p):
    rng = np.random.default_rng(p)
    cases = [(n, None) for n in (0, 1, 3, 7, 8, 25, 40)]
    for n in (0, 1, 3, 7, 40):
        cases.append((n, rng.integers(0, 50, size=n).astype(float)))
        cases.append((n, np.zeros(n)))                  # no cost at all
    heavy = np.ones(16)
    heavy[0] = 100.0                                    # one dominant example
    cases += [(16, heavy), (16, heavy[::-1].copy()), (5, [0, 0, 9, 0, 0])]
    empty = 0
    for n, w in cases:
        cuts = []
        for k in range(p):
            _as_process(monkeypatch, p, k)
            want = jmesh.predict_partition(n, weights=w)
            got = tmesh.predict_partition(n, weights=w)
            assert got == want and all(isinstance(x, int) for x in got)
            cuts.append(got)
        assert cuts[0][0] == 0 and cuts[-1][1] == n
        for (a, b), (c, d) in zip(cuts, cuts[1:]):
            assert b == c and a <= b and c <= d
        empty += sum(lo == hi for lo, hi in cuts)
    assert empty > 0 or p == 1      # empty slices were among the cases
    if p == 2:
        _as_process(monkeypatch, 2, 0)
        assert tmesh.predict_partition(16, weights=heavy) == (0, 1)


@pytest.mark.parametrize("topology,world", [
    ("1", 1), ("2", 2), ("4", 4), ("2x2", 4), ("4x2", 8), ("1x2", 2)])
def test_local_data_rows_matches_jax(monkeypatch, topology, world):
    """One device a process: the port's layout.  The JAX function reads a
    mesh's shape and its devices' ``process_index``, which a stand-in
    carries."""
    for rank in range(world):
        _as_process(monkeypatch, world, rank)
        mesh = tmesh.build_mesh(topology)
        d, m = mesh.data, mesh.model
        grid = np.empty((d, m), object)
        for i in range(d * m):
            grid[i // m, i % m] = types.SimpleNamespace(process_index=i)
        stand_in = types.SimpleNamespace(shape={"data": d, "model": m},
                                         devices=grid)
        for rows in (d, 4 * d, 64 * d):
            assert tmesh.local_data_rows(mesh, rows) == \
                jmesh.local_data_rows(stand_in, rows)
        if d > 1:
            for fn, arg in ((tmesh.local_data_rows, mesh),
                            (jmesh.local_data_rows, stand_in)):
                with pytest.raises(ValueError, match="not divisible"):
                    fn(arg, d + 1)


@pytest.mark.parametrize("topology", [None, "auto", "1", "8", "4x2", "2x4",
                                      "2", "2x2", "16", "4x4", "3x3"])
def test_build_mesh_parses_as_jax(monkeypatch, topology):
    """Eight devices there, eight ranks here: the same (data, model) shape
    or the same error."""
    _as_process(monkeypatch, 8, 3)
    try:
        want = dict(jmesh.build_mesh(topology, jax.devices()).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.build_mesh(topology)
        assert str(got.value) == str(e)
        return
    mesh = tmesh.build_mesh(topology)
    assert mesh.shape == want and (mesh.rank, mesh.world) == (3, 8)
    assert tmesh.data_axis_size(mesh) == want["data"]
    assert mesh.data_row == 3 // want["model"]
    assert not tmesh.is_main_process()
    # a multi-process predict sweeps on the local device alone
    assert tmesh.sweep_data_axis_size(mesh, predict=True) == 1
    assert tmesh.sweep_data_axis_size(mesh, predict=False) == want["data"]
    assert tmesh.predict_mesh(mesh).shape == {"data": 1, "model": 1}


def test_dropout_seeds_of_a_row_slice_are_the_global_draws():
    """Rank r of a sharded batch masks rows [lo, hi) as one process masks
    them: the seeds are drawn for the global batch, then cut."""
    state = create_train_state(NonvisualModel(emb_dim=4, hidden=3), seed=11)
    state.step = 5
    whole = state.dropout_seeds(64)
    assert whole.dtype == torch.int32 and len(set(whole.tolist())) > 60
    for lo, hi in ((0, 32), (32, 64), (16, 32), (0, 0)):
        assert torch.equal(state.dropout_seeds(64, rows=(lo, hi)),
                           whole[lo:hi])
    # two ranks' halves differ (the fault: each drew the same local seeds)
    assert not torch.equal(state.dropout_seeds(64, rows=(0, 32)),
                           state.dropout_seeds(64, rows=(32, 64)))


@pytest.mark.parametrize("task", ["relation", "affinity"])
def test_fresh_weights_do_not_depend_on_the_thread_count(task):
    """Two ranks that start from one seed hold one state, however many
    threads each finds free: the same bits at 1, 2 and 4 threads, the
    orthogonal recurrent kernels at full width included (a float32 QR
    moved them by 2e-7 here and by 6e-6 under two ranks on one host)."""
    from icl_torch.params import init_params

    dims = {"emb_dim": 300, "lstm_hidden": 256, "head_hidden": 64,
            "box_dim": 32}
    before = torch.get_num_threads()
    try:
        draws = []
        for n in (1, 2, 4):
            torch.set_num_threads(n)
            draws.append(init_params(task, 3, dims))
    finally:
        torch.set_num_threads(before)
    for other in draws[1:]:
        for key, value in draws[0].items():
            assert torch.equal(value, other[key]), key


@pytest.mark.parametrize("task", ["relation", "affinity"])
def test_fresh_weights_do_not_depend_on_the_host_lapack(task, monkeypatch):
    """The fresh state's one factorisation, the QR behind the orthogonal
    recurrent kernels, goes through no host LAPACK: one whose float64
    factor moves in its last bits from call to call, as a threaded
    LAPACK's does with the blocking it picks from the threads it finds
    (two ranks of one card once started 2.1e-06 apart), leaves the draws
    bit for bit as they were."""
    from icl_torch import params

    dims = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 64,
            "box_dim": 32}
    want = params.init_params(task, 3, dims)
    qr = torch.linalg.qr

    def moved(a, *args, **kwargs):
        q, r = qr(a, *args, **kwargs)
        return q * (1.0 + 1e-9), r

    monkeypatch.setattr(torch.linalg, "qr", moved)
    monkeypatch.setattr(np.linalg, "qr", moved)
    got = params.init_params(task, 3, dims)
    for key, value in want.items():
        assert torch.equal(value, got[key]), key


# --- train steps: ranks against one process and against JAX ----------------

def _relation_inputs(synth_dir, emb):
    ds = load_relation_dataset(synth_dir, "train", emb)
    arrays = next(iter(RelationBatcher(images_per_batch=4,
                                       build_grid=True).batches(ds))).arrays
    return {k: np.array(v) for k, v in arrays.items()}


def _jax_relation(table, arrays, steps):
    """The JAX package's weights at the start and after ``steps`` grid-loss
    steps at dropout 0 (its plain grid CE: no kernel in the way)."""
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    model = JaxRelationModel(lstm_hidden=REL_H, head_hidden=REL_HEAD,
                             dropout=0.0, fused=False)
    st = jax_create_train_state(model, (jnp.asarray(table), jb), seed=0)
    p0 = flatten_params(st.params)
    step = jax_steps.make_relation_train_step(
        class_weights=[0.3, 1.0, 1.0, 1.0], donate=False, grid_loss=True)
    losses = []
    for _ in range(steps):
        st, m = step(st, jnp.asarray(table), jb)
        losses.append(float(m["loss"]))
    return p0, flatten_params(st.params), losses


def _jax_affinity(table, arrays, steps):
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    model = JaxAffinityModel(lstm_hidden=LSTM_H, head_hidden=HEAD_H,
                             phrase_enc="lstm", dropout=0.0, fused=False)
    st = jax_create_train_state(model, (jnp.asarray(table), jb), seed=0)
    p0 = flatten_params(st.params)
    step = jax_steps.make_affinity_train_step(class_weights=[0.4, 1.0],
                                              donate=False, grid_loss=True)
    losses = []
    for _ in range(steps):
        st, m = step(st, jnp.asarray(table), jb)
        losses.append(float(m["loss"]))
    return p0, flatten_params(st.params), losses


def _jax_nonvisual(table, batch, steps):
    model = JaxNonvisualModel(hidden=MENTION_H, dropout=0.0)
    st = jax_create_train_state(model, (jnp.zeros((1, MENTION_D)),), seed=0)
    p0 = flatten_params(st.params)
    step = jax_steps.make_mention_train_step(donate=False)
    losses = []
    for _ in range(steps):
        st, m = step(st, jnp.asarray(table), *map(jnp.asarray, batch))
        losses.append(float(m["loss"]))
    return p0, flatten_params(st.params), losses


def _two_affinity_batches():
    """Eight images: ranks 0 and 1 of a pair each get four with valid
    cells (``affinity_batch`` ends in an image without boxes and a padded
    one, so its second half alone is all padding)."""
    a, b = affinity_batch(seed=6), affinity_batch(seed=7)
    return {k: np.concatenate([a[k][:2], b[k][:2], a[k][2:], b[k][2:]])
            for k in a}


@pytest.fixture(scope="module")
def dp(tmp_path_factory, synth_dir, emb):
    """The cases, the JAX package's results, two ranks (mesh 2) over all
    cases and four ranks (mesh 2x2) over two of them."""
    d = str(tmp_path_factory.mktemp("dist_steps"))
    d4 = str(tmp_path_factory.mktemp("dist_steps_2x2"))
    cases, want = [], {}

    def add(name, task, model, table, batch, params, steps, **kw):
        np.savez(os.path.join(d, name + ".npz"), table=table,
                 **{f"batch/{k}": v for k, v in batch.items()},
                 **{f"param/{k}": v for k, v in params.items()})
        cases.append({"name": name, "task": task, "model": model,
                      "steps": steps, "seed": 3, **kw})

    with jax.default_matmul_precision("highest"):
        rel = _relation_inputs(synth_dir, emb)
        rel_p0, *want["rel_grid_d0"] = _jax_relation(emb.table, rel, 3)
        aff, aff_t = _two_affinity_batches(), affinity_table()
        aff_p0, *want["aff_grid_d0"] = _jax_affinity(aff_t, aff, 3)
        nv = dict(zip(dist_worker.MENTION_KEYS, mention_batch(4, n=24)))
        nv_t = mention_table()
        nv_p0, *want["nv_d0"] = _jax_nonvisual(nv_t, tuple(nv.values()), 3)
    rel_m = dict(emb_dim=emb.dim, lstm_hidden=REL_H, head_hidden=REL_HEAD)
    cw = [0.3, 1.0, 1.0, 1.0]
    rel_kw = dict(class_weights=cw, grid_loss=True)
    add("rel_grid", "relation", {**rel_m, "fused": True, "dropout": 0.5},
        emb.table, rel, rel_p0, 4, **rel_kw)
    add("rel_pair", "relation", {**rel_m, "fused": False, "dropout": 0.5},
        emb.table, rel, rel_p0, 3, class_weights=cw, grid_loss=False)
    add("rel_grid_d0", "relation", {**rel_m, "fused": True, "dropout": 0.0},
        emb.table, rel, rel_p0, 3, **rel_kw)
    # every valid pair in rank 0's rows: rank 1 feeds padding only
    pad = {k: v.copy() for k, v in rel.items()}
    for k in ("pair_valid", "grid_valid", "m_valid"):
        pad[k][2:] = False
    assert pad["pair_valid"][:2].sum() > 4
    add("rel_pad", "relation", {**rel_m, "fused": True, "dropout": 0.5},
        emb.table, pad, rel_p0, 3, **rel_kw)
    aff_m = dict(emb_dim=EMB_D, box_dim=BOX_D, lstm_hidden=LSTM_H,
                 head_hidden=HEAD_H, phrase_enc="lstm", fused=True)
    aff_kw = dict(class_weights=[0.4, 1.0], grid_loss=True)
    add("aff_grid", "affinity", {**aff_m, "dropout": 0.5}, aff_t, aff,
        aff_p0, 3, **aff_kw)
    add("aff_grid_d0", "affinity", {**aff_m, "dropout": 0.0}, aff_t, aff,
        aff_p0, 3, **aff_kw)
    # affinity_batch alone: its second half (rank 1's rows) has no cell
    add("aff_pad", "affinity", {**aff_m, "dropout": 0.5}, aff_t,
        affinity_batch(seed=6), aff_p0, 3, **aff_kw)
    nv_m = dict(emb_dim=MENTION_D, hidden=MENTION_H)
    add("nv", "nonvisual", {**nv_m, "dropout": 0.5}, nv_t, nv, nv_p0, 5)
    add("nv_d0", "nonvisual", {**nv_m, "dropout": 0.0}, nv_t, nv, nv_p0, 3)
    with open(os.path.join(d, "cases.json"), "w") as f:
        json.dump(cases, f)
    four = [c for c in cases if c["name"] in ("rel_grid", "aff_grid")]
    for c in four:
        os.symlink(os.path.join(d, c["name"] + ".npz"),
                   os.path.join(d4, c["name"] + ".npz"))
    with open(os.path.join(d4, "cases.json"), "w") as f:
        json.dump(four, f)
    runs = {2: _spawn("steps", 2, d, "2"), 4: _spawn("steps", 4, d4, "2x2")}
    for world, res in runs.items():
        for rc, out in res:
            assert rc == 0 and "OK" in out, out
    return {"dir": {2: d, 4: d4}, "cases": {c["name"]: c for c in cases},
            "jax": want}


def _ranks(dp, name, world=2):
    return [dict(np.load(os.path.join(dp["dir"][world],
                                      f"{name}.rank{k}.npz")))
            for k in range(world)]


@pytest.mark.parametrize("name", ["rel_grid", "rel_pair", "aff_grid", "nv",
                                  "rel_pad", "aff_pad"])
def test_two_ranks_match_one_process_at_dropout_half(dp, name):
    """The masks are in play (dropout 0.5): the ranks' weights are equal bit
    for bit and within 1e-6 of one process over the whole batch.  In
    ``rel_pad`` and ``aff_pad`` rank 1 feeds padding only: the normaliser is
    the global weight sum, or the loss would double."""
    r0, r1 = _ranks(dp, name)
    one = dist_worker.run_case(dp["dir"][2], dp["cases"][name], None)
    assert sorted(r0) == sorted(one) and len(one) > 4
    assert np.isfinite(one["loss"]).all() and one["loss"][0] > 0.1
    for k in one:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_allclose(r0[k], one[k], atol=RANKS_GATE, rtol=0,
                                   err_msg=k)
    moved = max(float(np.abs(one[k] - np.load(os.path.join(
        dp["dir"][2], name + ".npz"))[k]).max())
        for k in one if k.startswith("param/"))
    assert moved > 1e-3              # the steps did train
    if dp["cases"][name].get("grid_loss"):
        # one process over the ranks' two row blocks, a call each (what the
        # card check holds the ranks to): the same step again
        halves = dist_worker.run_case(dp["dir"][2], dp["cases"][name], None,
                                      split=2)
        for k in one:
            np.testing.assert_allclose(halves[k], r0[k], atol=RANKS_GATE,
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["rel_grid", "aff_grid"])
def test_a_2x2_mesh_matches_one_process(dp, name):
    """Four ranks, data 2 x model 2: the ranks of a data row feed the same
    rows and count once."""
    ranks = _ranks(dp, name, world=4)
    one = dist_worker.run_case(dp["dir"][4], dp["cases"][name], None)
    for k in one:
        for r in ranks[1:]:
            np.testing.assert_array_equal(ranks[0][k], r[k], err_msg=k)
        np.testing.assert_allclose(ranks[0][k], one[k], atol=RANKS_GATE,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["rel_grid_d0", "aff_grid_d0", "nv_d0"])
def test_two_ranks_match_the_jax_steps_at_dropout_0(dp, name):
    want_params, want_losses = dp["jax"][name]
    r0, r1 = _ranks(dp, name)
    for k, v in want_params.items():
        np.testing.assert_array_equal(r0[f"param/{k}"], r1[f"param/{k}"])
        tol = JAX_GATE * max(1.0, float(np.abs(v).max()))
        assert float(np.abs(r0[f"param/{k}"] - v).max()) <= tol, k
    np.testing.assert_allclose(r0["loss"], want_losses, atol=JAX_GATE,
                               rtol=JAX_GATE)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_scores_are_the_parts_in_rank_order(dp, world):
    """Merged bytes = the ranks' own rows concatenated = one process's
    write of the whole arrays; the sidecar holds the global count; rank 0's
    slice is empty; no part is left."""
    d = dp["dir"][world]
    merged = open(os.path.join(d, "sharded.scores"), "rb").read()
    own = [open(os.path.join(d, f"sharded.scores.own{k}"), "rb").read()
           for k in range(world)]
    assert own[0] == b"" and merged == b"".join(own)
    rng = np.random.default_rng(5)
    write_scores(os.path.join(d, "whole.scores"),
                 [f"id{i}" for i in range(11)], rng.random((11, 3)))
    assert merged == open(os.path.join(d, "whole.scores"), "rb").read()
    meta = json.load(open(os.path.join(d, "sharded.scores.meta.json")))
    assert meta["num_examples"] == 11 and meta["num_classes"] == 3
    assert meta["class_order"] == ["a", "b", "c"] and meta["task"] == "check"
    assert not [n for n in os.listdir(d) if ".part-" in n]


# --- gather_parts' three outcomes ------------------------------------------

@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gather"))
    res = _spawn("gather", 2, d)
    said = {}
    for rc, out in res:
        assert rc == 0, out         # no rank hung or died: all three ran
        for line in out.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                said[row["mode"], row["rank"]] = row
    assert len(said) == 6, res
    return d, said


def test_merge_failure_raises_on_every_rank_and_keeps_parts(gathered):
    d, said = gathered
    # rank 0 re-raises the ORIGINAL merge error; rank 1 a RuntimeError
    # naming its kept part
    assert said["fail", 0]["outcome"] == "own error"
    assert "injected merge failure" in said["fail", 0]["message"]
    assert said["fail", 1]["outcome"] == "peer failure"
    assert "kept" in said["fail", 1]["message"]
    assert "merged.out.part-00001" in said["fail", 1]["message"]
    assert sorted(os.listdir(os.path.join(d, "fail"))) == [
        "merged.out.part-00000", "merged.out.part-00001"]


def test_write_failure_raises_on_every_rank_without_hanging(gathered):
    d, said = gathered
    # rank 1 re-raises its own write error; rank 0 learns of it BEFORE it
    # merges over a missing part, and keeps its own
    assert said["failwrite", 1]["outcome"] == "own error"
    assert "injected part-write failure" in said["failwrite", 1]["message"]
    assert said["failwrite", 0]["outcome"] == "peer failure"
    assert "part write failed on another rank" in \
        said["failwrite", 0]["message"]
    assert os.listdir(os.path.join(d, "failwrite")) == [
        "merged.out.part-00000"]


def test_merge_success_consumes_parts(gathered):
    d, said = gathered
    assert said["ok", 0] == {"mode": "ok", "rank": 0, "outcome": "ok",
                             "result": os.path.join(d, "ok", "merged.out")}
    assert said["ok", 1]["outcome"] == "ok" and said["ok", 1]["result"] is None
    assert os.listdir(os.path.join(d, "ok")) == ["merged.out"]
    with open(os.path.join(d, "ok", "merged.out")) as f:
        assert f.read() == "rank 0 payload\nrank 1 payload\n"


# --- runtime.init ------------------------------------------------------------

@pytest.mark.parametrize("topology,needle", [
    ("1", "no mesh devices"), ("4", "topology 4x1 needs 4 devices, have 2")])
def test_a_mesh_that_does_not_fit_the_ranks_exits_on_every_rank(topology,
                                                                needle):
    """Too small a mesh would strand a rank at the first collective, too
    large a one names ranks that are not there: every rank raises the same
    message and exits, none hangs."""
    res = _spawn("init", 2, topology, timeout=120)
    lines = []
    for rc, out in res:
        assert rc == 7, out
        lines += [ln for ln in out.splitlines() if "MESH-CHECK:" in ln]
    assert len(lines) == 2 and lines[0] == lines[1] and needle in lines[0]
    if topology == "1":
        assert "--mesh 2x1" in lines[0]          # the suggested remedy


def test_a_coordinator_without_process_id_runs_one_process(monkeypatch):
    said = []
    monkeypatch.setattr(runtime.LOG, "warning",
                        lambda msg, *a: said.append(msg % a))
    rt = runtime.init("256x1", seed=4, coordinator="pod:1234",
                      num_processes=256, device="cpu")
    assert not torch.distributed.is_initialized()
    assert rt.mesh.shape == {"data": 1, "model": 1} and rt.backend is None
    assert (rt.seed, rt.device.type, rt.num_devices) == (4, "cpu", 1)
    assert "no --process_id given: running single-process" in said[0]
    assert "falls back to local DP" in said[1]
    # without a coordinator an oversized mesh is an error, as in the
    # reference, and --process_id alone is refused
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        runtime.init("2", device="cpu")
    with pytest.raises(ValueError, match="requires --coordinator"):
        runtime.init(None, process_id=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runtime.init(None)                   # no rank falls back


# --- the kernels' libraries at first use, from two processes at once --------

def test_two_processes_build_one_library_at_the_same_moment(tmp_path):
    """Both ranks reach a kernel's first use together: each compiles under
    a name of its own and renames, so both end with one whole library.  A
    stand-in compiler (slow, writes its output in two halves) takes nvcc's
    place."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ \"$1\" != \"-o\" ]; do shift; done\n"
        "printf 'first half ' > \"$2\"; sleep 0.5\n"
        "printf 'second half' >> \"$2\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    code = (
        "import sys, pathlib\n"
        "from icl_torch.ops import _build\n"
        f"_build.BUILD_DIR = pathlib.Path({str(tmp_path / 'out')!r})\n"
        "path, secs = _build.build('grid_head')\n"
        "print(path.read_text(), secs > 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_HOME=str(tmp_path / "cuda"))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert out.strip() == "first half second half True", out
    left = sorted(n.name for n in (tmp_path / "out").iterdir())
    assert len(left) == 2 and left[0].endswith(".log") \
        and left[1].endswith(".so"), left
