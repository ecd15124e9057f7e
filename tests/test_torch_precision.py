"""``--matmul_precision`` and the one-pass bf16 mode of the training
grid-head kernels (K5-K8), on the CPU.

XLA:CPU ignores ``Precision.DEFAULT``: the JAX package's training kernels
give the same results at ``exact=False`` as at ``exact=True`` here
(:func:`test_the_jax_kernels_ignore_default_precision_on_the_cpu`), so it
cannot be the reference for the rounding.  The plain versions of the
one-pass mode are held instead to a numpy emulation written from the
reference's kernels (icl/ops/grid_head_train.py: the ``Precision.DEFAULT``
dots of ``_fwd_kernel``, ``_bwd_dz``/``_bwd_kernel``, ``_logit_tile`` and
``_bwd_loss_kernel``): both operands of each head contraction rounded to
bf16 (nearest even, by ``jnp.bfloat16``) and their exact products summed
(here in float64); hd rounded after the dropout scale, z = (X + b1) + Y
formed in f32 in that order; dz, dX, dY, db1, db2 and the CE unrounded.
The dropout mask is the port's hash mask (the JAX package's is the TPU's
PRNG, which cannot run here).  Gate: 1e-5 * max(1, max |emulation|).
K8's backward half is fed, on both sides, the same f32 logit gradient g3
(held to the emulation's first): a g3 one f32 unit apart may round to the
neighbouring bf16 value.

The CLI side: :func:`icl_torch.cli._common.precision_policy` is the table
of PERF.md section 2; on the CPU every mode is exact f32, so a CPU train
step under ``default`` matches the JAX step under ``default`` at 1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from icl.cli.export import flatten_params
from icl.data.imagebatch import RelationBatcher
from icl.data.pipeline import load_relation_dataset
from icl.ops import grid_head_train as jax_ght
from icl_torch.cli import _common as tcommon
from icl_torch.cli import affinity as taffinity
from icl_torch.cli import cardinality as tcardinality
from icl_torch.cli import joint as tjoint
from icl_torch.cli import nonvisual as tnonvisual
from icl_torch.cli import relation as trelation
from icl_torch.models.affinity import AffinityModel
from icl_torch.models.relation import RelationModel
from icl_torch.ops import grid_head_train as ght
from icl_torch.testing.synth import SynthConfig, generate_dataset
from icl_torch.train import steps
from icl_torch.train.checkpoint import Checkpointer
from icl_torch.train.state import create_train_state

from test_torch_affinity import _table as affinity_table
from test_torch_affinity import _torch, affinity_batch
from test_torch_affinity_train import _jax_step as jax_affinity_step
from test_torch_train import _jax_step as jax_relation_step

GATE = 1e-5
ONE_PASS = 2.0 ** -7 + 2.0 ** -16   # |ra * rb - a * b| / |a b|, bf16 (RNE)
RATE = 0.5


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = GATE * max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol, (what, err, tol)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bf16(a):
    """``a`` (f32) rounded to bf16, nearest even, as float64."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)
                      .astype(jnp.float32), np.float64)


# --- the problem and the emulation ----------------------------------------

def _problem(G, A, B, K, O, density=0.75, seed=5):
    rng = np.random.default_rng(seed)
    f = np.float32
    X = (rng.normal(size=(G, A, K)) * 0.5).astype(f)
    Y = (rng.normal(size=(G, B, K)) * 0.5).astype(f)
    b1 = (rng.normal(size=(K,)) * 0.1).astype(f)
    W2 = (rng.normal(size=(K, O)) * 0.4).astype(f)
    b2 = (rng.normal(size=(O,)) * 0.1).astype(f)
    seeds = rng.integers(0, 2 ** 31 - 1, size=(G,)).astype(np.int32)
    labels = rng.integers(0, O, size=(G, A, B)).astype(np.int32)
    weights = ((rng.random((G, A, B)) < density)
               * rng.choice([0.3, 1.0], size=(G, A, B))).astype(f)
    g = rng.normal(size=(G, A, B, O)).astype(f)
    return {"X": X, "Y": Y, "b1": b1, "W2": W2, "b2": b2, "seeds": seeds,
            "labels": labels, "weights": weights, "g": g,
            "gl": np.float32(0.37)}


def _t(p, *names):
    return [torch.from_numpy(np.asarray(p[n])) for n in names]


def _hd_scale(p, rate):
    """hd = dropout(relu(z)) and dz's factor [z > 0] * keep * scale, f32,
    z = (X + b1) + Y (the reference folds b1 into X first)."""
    z = (p["X"] + p["b1"])[:, :, None, :] + p["Y"][:, None, :, :]
    hd = np.maximum(z, np.float32(0))
    scale = (z > 0).astype(np.float32)
    if rate > 0:
        G, A, B, K = z.shape
        keep = ght.dropout_keep_mask(torch.from_numpy(p["seeds"]), A, B, K,
                                     rate).numpy()
        kf = np.where(keep, np.float32(ght.dropout_scale(rate)),
                      np.float32(0))
        hd, scale = hd * kf, scale * kf
    return hd, scale


def _emul_logits(p, rate):
    """_fwd_kernel / _logit_tile at exact=False: one bf16 pass of hd . W2,
    then + b2."""
    hd, _ = _hd_scale(p, rate)
    return np.einsum("gabk,ko->gabo", _bf16(hd), _bf16(p["W2"])) + p["b2"]


def _emul_bwd(p, g, rate):
    """_bwd_dz and _bwd_kernel at exact=False: dh = round(g) . round(W2)^T,
    dz = dh * scale (f32 math), dW2 = round(hd)^T . round(g)."""
    hd, scale = _hd_scale(p, rate)
    gr = _bf16(g)
    dz = np.einsum("gabo,ko->gabk", gr, _bf16(p["W2"])) * scale
    return (dz.sum(2), dz.sum(1), np.einsum("gabk,gabo->ko", _bf16(hd), gr),
            dz.sum((0, 1, 2)))


def _emul_ce_sums(logits, labels, weights):
    """_fwd_loss_kernel: sum ce * w, hits (first-max argmax) and valid."""
    sh = logits - logits.max(-1, keepdims=True)
    ce = np.log(np.exp(sh).sum(-1)) - np.take_along_axis(
        sh, labels[..., None].astype(np.int64), -1)[..., 0]
    valid = weights > 0
    hits = (logits.argmax(-1) == labels) & valid
    return (ce * weights).sum(), float(hits.sum()), float(valid.sum())


def _emul_g3(logits, p):
    """_bwd_loss_kernel's g3 = (softmax - onehot) * w * gl."""
    e = np.exp(logits - logits.max(-1, keepdims=True))
    onehot = p["labels"][..., None] == np.arange(logits.shape[-1])
    return ((e / e.sum(-1, keepdims=True) - onehot)
            * (p["weights"] * p["gl"])[..., None])


def _port(p, rate, exact):
    """The four plain versions (the wrappers on CPU tensors) and K8's g3."""
    X, Y, b1, W2, b2, seeds, labels, weights, g = _t(
        p, "X", "Y", "b1", "W2", "b2", "seeds", "labels", "weights", "g")
    gl = torch.tensor(p["gl"])
    logits = ght.grid_head_train_fwd(X, Y, b1, W2, b2, seeds, rate, exact)
    return {"K5": logits,
            "K6": ght.grid_head_train_bwd(X, Y, b1, W2, seeds, g, rate,
                                          exact),
            "K7": ght.grid_head_train_loss_fwd(X, Y, b1, W2, b2, seeds,
                                               labels, weights, rate, exact),
            "K8": ght.grid_head_train_loss_bwd(X, Y, b1, W2, b2, seeds,
                                               labels, weights, gl, rate,
                                               exact),
            "g3": ght._dlogits(logits, labels, weights, gl)}


def _check_against_emulation(p, rate):
    got = _port(p, rate, exact=False)
    logits = _emul_logits(p, rate)
    _close(_np(got["K5"]), logits, "K5 logits")
    for name, a, b in zip(("dX", "dY", "dW2", "db1"), got["K6"],
                          _emul_bwd(p, p["g"], rate)):
        _close(_np(a), b, f"K6 {name}")
    for name, a, b in zip(("loss", "hits", "valid"), got["K7"],
                          _emul_ce_sums(logits, p["labels"], p["weights"])):
        _close(_np(a), b, f"K7 {name}")
    g3 = _np(got["g3"])
    _close(g3, _emul_g3(logits, p), "K8 g3")
    want = (*_emul_bwd(p, g3, rate), g3.astype(np.float64).sum((0, 1, 2)))
    for name, a, b in zip(("dX", "dY", "dW2", "db1", "db2"), got["K8"], want):
        _close(_np(a), b, f"K8 {name}")
    return got


# one tile per image on the JAX side (its flat kernels), a shape it tiles
# (Ta=16, Tb=32: its general kernels), and ragged tile edges with K no
# multiple of 4 and odd head widths
SHAPES = [(3, 10, 13, 48, 4), (2, 24, 40, 32, 4), (1, 5, 7, 30, 1),
          (2, 20, 33, 30, 8)]


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("G,A,B,K,O", SHAPES)
def test_onepass_plain_versions_match_the_emulation(G, A, B, K, O, rate):
    _check_against_emulation(_problem(G, A, B, K, O), rate)


@pytest.mark.parametrize("density", [0.0, 0.19, 1.0])
@pytest.mark.parametrize("G,A,B,K,O", [(3, 16, 16, 48, 4), (2, 9, 20, 30, 2)])
def test_onepass_plain_versions_at_weight_density(G, A, B, K, O, density):
    got = _check_against_emulation(_problem(G, A, B, K, O, density, seed=8),
                                   RATE)
    if density == 0.0:
        assert not any(_np(t).any() for t in (*got["K7"], *got["K8"]))


def test_the_rounding_follows_the_dropout_scale():
    """hd is rounded after the dropout scale: at rate 0.5 the scale is 2
    and the order does not matter, at rate 0.3 (scale 1/0.7) it does; the
    plain version rounds hd * scale, not round(hd) * scale."""
    p = _problem(2, 6, 7, 64, 4, seed=21)
    rate = 0.3
    got = _np(_port(p, rate, exact=False)["K5"])
    _close(got, _emul_logits(p, rate), "K5 logits at rate 0.3")
    hd, _ = _hd_scale(p, 0.0)
    keep = ght.dropout_keep_mask(torch.from_numpy(p["seeds"]), 6, 7, 64,
                                 rate).numpy()
    early = np.einsum("gabk,ko->gabo", _bf16(hd) * np.where(
        keep, np.float32(ght.dropout_scale(rate)), 0.0),
        _bf16(p["W2"])) + p["b2"]
    assert np.abs(got - early).max() > 10 * GATE


# --- the gap from exact f32: non-zero, and within one bf16 pass -------------

def _bound_bwd(p, g, rate):
    """Per element of (dX, dY, dW2, db1): the one-pass bound of K6 with
    cotangent g, ONE_PASS * sum |a| |b| over the products that reach it."""
    hd, scale = _hd_scale(p, rate)
    ag, aw = np.abs(g).astype(np.float64), np.abs(p["W2"]).astype(np.float64)
    dz = ONE_PASS * np.einsum("gabo,ko->gabk", ag, aw) * np.abs(scale)
    return (dz.sum(2), dz.sum(1),
            ONE_PASS * np.einsum("gabk,gabo->ko", np.abs(hd), ag),
            dz.sum((0, 1, 2)))


def _linear_bwd(p, dg, rate):
    """|K6| at exact f32 of a cotangent difference dg, by absolute values
    (dX, dY, dW2, db1, db2)."""
    hd, scale = _hd_scale(p, rate)
    adg = np.abs(dg).astype(np.float64)
    dz = np.einsum("gabo,ko->gabk", adg, np.abs(p["W2"])) * np.abs(scale)
    return (dz.sum(2), dz.sum(1), np.einsum("gabk,gabo->ko", np.abs(hd), adg),
            dz.sum((0, 1, 2)), adg.sum((0, 1, 2)))


def _within(what, onepass, exact, bound):
    onepass, exact = _np(onepass).astype(np.float64), _np(exact)
    gap = np.abs(onepass - exact)
    slack = GATE * max(1.0, float(np.abs(exact).max()))   # f32 sum order
    assert gap.max() > 0, f"{what}: the one-pass mode equals exact f32"
    assert (gap <= bound + slack).all(), (what, float((gap - bound).max()))


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("G,A,B,K,O", [(3, 10, 13, 48, 4), (2, 9, 20, 64, 2),
                                       (2, 20, 33, 30, 8)])
def test_onepass_differs_from_exact_within_one_bf16_pass(G, A, B, K, O, rate):
    p = _problem(G, A, B, K, O, seed=13)
    one, ex = _port(p, rate, False), _port(p, rate, True)
    hd, _ = _hd_scale(p, rate)
    logit_bound = ONE_PASS * np.einsum("gabk,ko->gabo", np.abs(hd),
                                       np.abs(p["W2"]).astype(np.float64))
    _within("K5 logits", one["K5"], ex["K5"], logit_bound)
    for name, a, b, bnd in zip(("dX", "dY", "dW2", "db1"), one["K6"],
                               ex["K6"], _bound_bwd(p, p["g"], rate)):
        _within(f"K6 {name}", a, b, bnd)
    # the CE is 2-Lipschitz in the max norm of a cell's logits
    loss_bound = 2 * (p["weights"] * logit_bound.max(-1)).sum()
    _within("K7 loss", one["K7"][0], ex["K7"][0], loss_bound)
    # K8: one pass on the one-pass g3, plus exact f32 on g3's own change
    g3 = _np(one["g3"])
    dg3 = g3.astype(np.float64) - _np(ex["g3"])
    onepass_part = (*_bound_bwd(p, g3, rate), 0.0)
    for name, a, b, x, y in zip(("dX", "dY", "dW2", "db1", "db2"), one["K8"],
                                ex["K8"], onepass_part,
                                _linear_bwd(p, dg3, rate)):
        _within(f"K8 {name}", a, b, x + y)


def test_the_jax_kernels_ignore_default_precision_on_the_cpu():
    """The fact this file rests on: the JAX package's K7/K8 and K5/K6 at
    exact=False give exact=True's loss, logits and gradients on the CPU, up
    to the f32 order of the sums (the dot against the lane sum): XLA:CPU
    ignores Precision.DEFAULT.  One bf16 pass, as the port's plain versions
    take it, lands hundreds of times farther off."""
    p = _problem(3, 10, 13, 48, 4, seed=2)
    params = [jnp.asarray(p[k]) for k in ("X", "Y", "b1", "W2", "b2")]
    extra = [jnp.asarray(p[k]) for k in ("seeds", "labels", "weights")]
    R = jnp.asarray(p["g"])
    out = {}
    for exact in (False, True):
        def loss(*q, exact=exact):
            sums = jax_ght.grid_head_train_loss(*q, *extra, 0.0, exact)
            grid = jax_ght.grid_head_train(*q, extra[0], 0.0, exact)
            return sums[0] + jnp.sum(grid * R), (sums, grid)

        out[exact] = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                        has_aux=True)(*params)
    a = jax.tree_util.tree_leaves(out[False])
    b = jax.tree_util.tree_leaves(out[True])
    assert len(a) == len(b) == 10
    for x, y in zip(a, b):
        _close(np.asarray(x), np.asarray(y))
    jax_gap = abs(float(out[False][0][1][0][0])
                  - float(out[True][0][1][0][0]))     # the loss sums
    one, ex = _port(p, 0.0, False), _port(p, 0.0, True)
    assert abs(float(one["K7"][0]) - float(ex["K7"][0])) > 100 * max(
        jax_gap, GATE)


# --- the policy --------------------------------------------------------------

# PERF.md section 2: (resolved mode, device) -> (TF32, exact K5-K8)
POLICY = {("default", "cuda"): (True, False), ("high", "cuda"): (False, False),
          ("highest", "cuda"): (False, True), ("default", "cpu"): (False, True),
          ("high", "cpu"): (False, True), ("highest", "cpu"): (False, True)}


@pytest.fixture
def torch_flags():
    """Restores the global matmul flags a test sets."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    yield
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction) = keep


@pytest.mark.parametrize("predict", [False, True])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("mode", [None, "default", "high", "highest"])
def test_the_precision_policy(mode, device, predict):
    """Resolved as the reference resolves it (train -> default, predict ->
    high), then mapped onto the device."""
    got = tcommon.precision_policy(mode, device, predict)
    want = mode or ("high" if predict else "default")
    assert got == tcommon.Precision(want, *POLICY[(want, device)])


def test_apply_precision_sets_the_flags_both_ways(torch_flags):
    def run(mode, device, predict=False):
        args = _parse(["--matmul_precision", mode] if mode else [],
                      "relation", predict)
        return tcommon.apply_precision(args, torch.device(device))

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    for mode, device, predict in (("default", "cuda", False),
                                  ("highest", "cuda", False),
                                  (None, "cuda", False), (None, "cuda", True),
                                  ("high", "cuda", False),
                                  ("default", "cpu", False),
                                  ("default", "cuda", False)):
        prec = run(mode, device, predict)
        assert torch.backends.cuda.matmul.allow_tf32 is prec.tf32
        assert torch.backends.cudnn.allow_tf32 is prec.tf32
        assert prec.tf32 == (prec.mode == "default" and device == "cuda")
        assert not torch.backends.cuda.matmul.\
            allow_bf16_reduced_precision_reduction


# --- the command lines -----------------------------------------------------------

def _parse(extra, task, predict=False):
    p = tcommon.base_parser(task, "")
    p.add_argument("--fused", default="auto", choices=["auto", "on", "off"])
    return tcommon.parse_task_args(
        p, ["--predict" if predict else "--train", "--data_dir", "x",
            *extra], task)


@pytest.mark.parametrize("mode", ["default", "high", "highest"])
@pytest.mark.parametrize("task", ["relation", "affinity", "nonvisual",
                                  "cardinality"])
def test_the_task_clis_take_every_precision(task, mode, torch_flags):
    """No task CLI refuses a value of ``--matmul_precision``; on the card
    each resolves to its row of the table."""
    args = _parse(["--matmul_precision", mode], task)
    assert args.matmul_precision == mode
    prec = tcommon.apply_precision(args, torch.device("cuda"))
    assert (prec.mode, prec.tf32, prec.head_exact) == (
        mode, *POLICY[(mode, "cuda")])


@pytest.mark.parametrize("mode", ["default", "high", "highest"])
def test_joint_forwards_the_precision_to_every_sub_run(mode, monkeypatch):
    seen = []
    for mod in (tjoint.nv_cli, tjoint.rel_cli, tjoint.aff_cli,
                tjoint.card_cli):
        monkeypatch.setattr(mod, "main", seen.append)
    tjoint.main(["--predict", "--data_dir", "x", "--with_cardinality",
                 "--with_rank", "--matmul_precision", mode])
    assert len(seen) == 4
    assert all(argv[argv.index("--matmul_precision") + 1] == mode
               for argv in seen)


def test_the_mention_clis_resolve_the_precision(monkeypatch):
    """The mention CLIs share ``_mention_task.run``, which applies the
    policy (its cuBLAS half: no training kernel lies on their path)."""
    seen = []
    real = tcommon.apply_precision

    def spy(args, device):
        seen.append(real(args, device))
        raise SystemExit(0)

    monkeypatch.setattr("icl_torch.cli._mention_task.apply_precision", spy)
    for cli in (tnonvisual, tcardinality):
        with pytest.raises(SystemExit):
            cli.main(["--train", "--data_dir", "x", "--device", "cpu",
                      "--matmul_precision", "high"])
    assert [p.mode for p in seen] == ["high", "high"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny planted split; relation and affinity trained on the CPU with
    the kernels' plain versions (``--fused on``) under no flag, ``default``
    and ``highest``."""
    d = str(tmp_path_factory.mktemp("precision_cli"))
    kw = dict(planted=True, emb_dim=16, vocab_size=40, max_caption_len=20,
              max_mentions_per_caption=3, max_boxes_per_image=6)
    generate_dataset(d, "train", SynthConfig(num_images=8, seed=1, **kw))
    out = {"dir": d}
    for task, cli in (("relation", trelation), ("affinity", taffinity)):
        for mode in (None, "default", "highest"):
            model_dir = f"{d}/{task}.{mode}"
            cli.main(["--train", "--data_dir", d, "--device", "cpu",
                      "--fused", "on", "--epochs", "2",
                      "--images_per_batch", "4", "--lstm_hidden_width", "8",
                      "--head_hidden", "16", "--model_file", model_dir,
                      *(["--matmul_precision", mode] if mode else [])])
            out[task, mode] = model_dir
    return out


@pytest.mark.parametrize("task", ["relation", "affinity"])
def test_cpu_train_under_default_writes_the_bits_of_highest(trained, task):
    """On the CPU the training kernels stay exact in every mode, so a
    ``--train`` under ``default`` (named, or by default) writes the
    checkpoint ``highest`` writes, bit for bit; train_config.json records
    the resolved mode."""
    ends = {}
    for mode in (None, "default", "highest"):
        model_dir = trained[task, mode]
        step = Checkpointer(model_dir).latest_step
        ends[mode] = torch.load(f"{model_dir}/step_{step}.pt",
                                weights_only=True)["model"]
        cfg = json.load(open(os.path.join(model_dir, "train_config.json")))
        assert (cfg["_matmul_precision"], cfg["_tf32"], cfg["_head_exact"]) \
            == (mode or "default", False, True)
    for mode in (None, "default"):
        assert ends[mode].keys() == ends["highest"].keys()
        assert all(torch.equal(v, ends["highest"][k])
                   for k, v in ends[mode].items())


# --- one train step under default against the JAX package's ----------------

@pytest.mark.parametrize("form", ["grid", "pair_null0"])
def test_relation_train_step_under_default_matches_jax(emb, synth_dir, form,
                                                       torch_flags):
    """Both sides at their ``--train`` default: the JAX model reads
    ``exact = False`` from its global precision (its kernels take one bf16
    pass on a TPU, exact f32 on the CPU); the port's CPU policy is exact."""
    cw = [0.3, 1.0, 1.0, 1.0] if form == "grid" else [0.0, 1.0, 1.0, 1.0]
    ds = load_relation_dataset(synth_dir, "train", emb)
    arrays = next(iter(RelationBatcher(images_per_batch=4,
                                       build_grid=True).batches(ds))).arrays
    table = jnp.asarray(emb.table)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    assert jax.config.jax_default_matmul_precision in (None, "default")
    st, new, jm, jgrads = jax_relation_step(True, True, cw, table, jb)

    prec = tcommon.apply_precision(_parse([], "relation"), "cpu")
    assert prec.mode == "default" and prec.head_exact
    model = RelationModel(emb.dim, 8, 16, fused=True, dropout=0.0,
                          exact=prec.head_exact)
    state = create_train_state(model, params={
        k: v.copy() for k, v in flatten_params(st.params).items()})
    step = steps.make_relation_train_step(class_weights=cw, grid_loss=True)
    tm = step(state, torch.from_numpy(emb.table),
              {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})
    _close(_np(tm["loss"]), jm["loss"], "loss")
    grads = {k.replace(".", "/"): p.grad for k, p in model.named_parameters()}
    for k, want in flatten_params(jgrads).items():
        _close(_np(grads[k]), want, f"grad {k}")
    for k, want in flatten_params(new.params).items():
        _close(_np(model.flat_params()[k]), want, f"new param {k}")


@pytest.mark.parametrize("form", ["grid", "cell_w0"])
def test_affinity_train_step_under_default_matches_jax(form, torch_flags):
    cw = [0.4, 1.0] if form == "grid" else [0.0, 1.0]
    table_np, arrays = affinity_table(), affinity_batch(seed=6)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    assert jax.config.jax_default_matmul_precision in (None, "default")
    new, jm, jgrads, p0 = jax_affinity_step("lstm", True, True, cw,
                                            jnp.asarray(table_np), jb)

    prec = tcommon.apply_precision(_parse([], "affinity"), "cpu")
    model = AffinityModel(table_np.shape[1], arrays["box_feats"].shape[-1],
                          8, 16, fused=True, dropout=0.0,
                          exact=prec.head_exact)
    state = create_train_state(model, params={k: v.copy()
                                              for k, v in p0.items()})
    step = steps.make_affinity_train_step(class_weights=cw, grid_loss=True)
    assert step.grid_loss == (form == "grid")
    tm = step(state, torch.from_numpy(table_np), _torch(arrays))
    _close(tm["loss"].numpy(), jm["loss"], "loss")
    grads = {k.replace(".", "/"): p.grad for k, p in model.named_parameters()}
    for k, want in flatten_params(jgrads).items():
        _close(grads[k].numpy(), want, f"grad {k}")
    for k, want in flatten_params(new.params).items():
        _close(model.flat_params()[k].numpy(), want, f"new param {k}")


@pytest.mark.parametrize("fused", [True, False])
def test_the_model_takes_the_onepass_mode_only_in_training(fused):
    """``exact=False`` reaches the training kernels and no other path: the
    deterministic grid loss (a dev eval) and predict stay exact, as the
    reference pins its predict kernel; the gather form has no kernel."""
    p = _problem(2, 5, 5, 16, 4, seed=3)
    X, Y = _t(p, "X", "Y")
    labels, weights = _t(p, "labels", "weights")
    model = AffinityModel(8, 8, 4, 16, num_classes=4, fused=fused,
                          dropout=0.0, exact=False)
    create_train_state(model, seed=1)
    seeds = torch.tensor([3, 4], dtype=torch.int32)
    with torch.no_grad():
        b1 = model.head_dense_phrase.bias
        W2, b2 = model.head_out.kernel, model.head_out.bias
        train = model.head(X, Y, seeds, (labels, weights))
        dev = model.head(X, Y, None, (labels, weights))
        want_dev = ght.grid_head_train_loss_reference(
            X, Y, b1, W2, b2, seeds, labels, weights, 0.0, True)
        for a, b in zip(dev, want_dev):
            assert torch.equal(a, b)
        want_train = ght.grid_head_train_loss_reference(
            X, Y, b1, W2, b2, seeds, labels, weights, 0.0, not fused)
        for a, b in zip(train, want_train):
            assert torch.equal(a, b)


@pytest.mark.parametrize("exact", [True, False])
def test_loss_backward_hands_out_its_logit_gradient(exact):
    """``g3_out`` receives K8's logit gradient (the plain g3 on the CPU) and
    changes none of the gradients."""
    p = _problem(2, 6, 7, 32, 4, seed=4)
    args = _t(p, "X", "Y", "b1", "W2", "b2", "seeds", "labels", "weights")
    gl = torch.tensor(p["gl"])
    g3 = torch.full((2, 6, 7, 4), float("nan"))
    got = ght.grid_head_train_loss_bwd(*args, gl, RATE, exact, g3_out=g3)
    want = ght.grid_head_train_loss_bwd(*args, gl, RATE, exact)
    assert torch.equal(g3, ght.grid_head_train_dlogits_plain(
        *args, gl, RATE, exact))
    assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
