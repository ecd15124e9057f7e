"""Hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without an NVIDIA GPU.  The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

f32, TF32 off.  Gate: max |kernel - plain| <= 1e-5 * max(1, max |plain|);
the kernels sum in another order than cuBLAS and the eager ops.  The
training kernels (K5-K8) are checked at dropout rate 0 and 0.5: kernels and
plain versions compute one hash mask, so both rates compare exactly.  The
box ranking (K9) and the affinity model are checked at the affinity shapes
(K=1024, O=2, A != B, a one-direction phrase LSTM).
"""

import pytest
import torch

from icl_torch.models.affinity import AffinityModel
from icl_torch.models.relation import RelationModel
from icl_torch.ops import affinity_rank as ar
from icl_torch.ops import grid_head as gh
from icl_torch.ops import grid_head_train as ght
from icl_torch.ops.affinity_rank import affinity_rank, affinity_rank_reference
from icl_torch.ops.grid_head import grid_head, grid_head_reference
from icl_torch.ops.lstm_recurrence import (lstm_recurrence,
                                           lstm_recurrence_bwd,
                                           lstm_recurrence_bwd_kernel,
                                           lstm_recurrence_fwd,
                                           lstm_recurrence_reference)
from icl_torch.params import init_params, init_relation_params
from icl_torch.tools.kernel_bits import bf16_units
from icl_torch.train.steps import (affinity_loss, affinity_predict,
                                   relation_loss, relation_predict)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want):
    tol = 1e-5 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, (err, tol)


def _head_inputs(G, A, B, K, O, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    X, Y = (torch.randn(G, n, K, generator=g, device=dev) for n in (A, B))
    b1 = torch.randn(K, generator=g, device=dev)
    W2 = torch.randn(K, O, generator=g, device=dev) / K ** 0.5
    b2 = torch.randn(O, generator=g, device=dev)
    return X, Y, b1, W2, b2


@pytest.mark.parametrize("G,A,B,K,O", [
    (1, 8, 8, 800, 4), (8, 16, 16, 800, 4), (64, 32, 32, 800, 4),
    (3, 9, 130, 16, 2), (2, 5, 7, 33, 3), (2, 4, 4, 1024, 2),
    # ragged register tiles (A, B no multiple of 4), K no multiple of 4 or
    # of a 128-wide pass, every head width, the relation and affinity
    # batch shapes, a K split over one and several passes
    (1, 5, 7, 30, 1), (2, 7, 9, 50, 2), (2, 9, 17, 800, 3), (1, 17, 20, 1024, 4),
    (2, 20, 33, 50, 8), (3, 33, 5, 800, 8), (1, 16, 16, 800, 4),
    (4, 16, 32, 1024, 2), (64, 16, 16, 800, 4), (64, 16, 32, 1024, 2),
    (1, 1, 1, 4, 2), (5, 4, 4, 132, 4)])
def test_grid_head_kernel_matches_plain(dev, G, A, B, K, O):
    args = _head_inputs(G, A, B, K, O, dev)
    n0 = grid_head.launches
    out = grid_head(*args)
    torch.cuda.synchronize()
    assert grid_head.launches == n0 + 1
    _assert_close(out, grid_head_reference(*args))
    assert torch.equal(out, grid_head(*args))       # bitwise repeatable


def _offset_view(t, floats=1):
    """A contiguous copy of t whose storage starts `floats` floats into an
    allocation: 4-byte aligned only."""
    flat = torch.empty(t.numel() + floats, dtype=t.dtype, device=t.device)
    view = flat[floats:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("which", [0, 1, 2, 3])
@pytest.mark.parametrize("G,A,B,K,O", [(8, 16, 16, 800, 4),
                                       (4, 16, 20, 1024, 2)])
def test_grid_head_kernel_takes_an_unaligned_view(dev, G, A, B, K, O, which):
    """One of X, Y, b1, W2 only 4-byte aligned: the scalar form, same
    values."""
    args = list(_head_inputs(G, A, B, K, O, dev))
    want = grid_head_reference(*args)
    args[which] = _offset_view(args[which])
    out = grid_head(*args)
    _assert_close(out, want)
    assert torch.equal(out, grid_head(*args))


def test_grid_head_empty_grid_launches_nothing(dev):
    args = _head_inputs(2, 0, 4, 800, 4, dev)
    n0 = grid_head.launches
    out = grid_head(*args)
    assert out.shape == (2, 0, 4, 4) and grid_head.launches == n0


def _rec_inputs(G, L, B, H, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x_proj = torch.randn(G, L, B, 4 * H, generator=g, device=dev)
    R = torch.randn(G, H, 4 * H, generator=g, device=dev) / H ** 0.5
    lengths = torch.randint(0, L + 1, (B,), generator=g, device=dev)
    if B:
        lengths[0] = 0
        lengths[-1] = L
    t = torch.arange(L, device=dev)[:, None]
    mask = torch.stack([t < lengths, (L - 1 - t) < lengths])[:G]
    return x_proj, mask.contiguous(), R


@pytest.mark.parametrize("G,L,B,H", [
    (2, 16, 8, 200), (2, 32, 64, 200), (2, 48, 37, 200), (1, 1, 3, 8),
    (2, 9, 13, 40), (2, 5, 6, 3), (1, 7, 5, 256),
    # no multiple of the kernel's 8-row tile; a lone second tile; the widest
    # and a narrow H; the affinity batch; two steps (one hand-over of h)
    (2, 32, 61, 200), (2, 32, 9, 200), (2, 16, 61, 256), (2, 16, 61, 64),
    (1, 16, 1024, 200), (2, 2, 17, 200), (2, 3, 9, 1),
    # past 256 units, the 16-block cluster: R on chip up to 368, read from
    # device memory above
    (2, 16, 61, 300), (1, 5, 9, 257), (2, 8, 17, 512), (2, 2, 64, 300),
    (1, 4, 9, 368), (2, 4, 9, 369),
    # one unit a block, a ragged last block; one row; one step
    (2, 8, 13, 8), (2, 8, 13, 9), (2, 16, 13, 201), (2, 16, 1, 200),
    (2, 1, 13, 200)])
def test_recurrence_kernel_matches_plain(dev, G, L, B, H):
    args = _rec_inputs(G, L, B, H, dev)
    n0 = lstm_recurrence.launches
    hs, fin = lstm_recurrence(*args)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == n0 + 1
    hs_ref, fin_ref = lstm_recurrence_reference(*args)
    _assert_close(hs, hs_ref)
    _assert_close(fin, fin_ref)
    if B > 1:      # _rec_inputs gives row 0 length 0, the last row L
        assert not hs[:, :, 0].any()                # the length-0 row
    hs2, _ = lstm_recurrence(*args)
    assert torch.equal(hs, hs2)                     # bitwise repeatable


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x_proj, mask, R = _rec_inputs(2, 4, 8, 16, dev)
    with pytest.raises(TypeError):
        lstm_recurrence(x_proj.double(), mask, R.double())
    with pytest.raises(ValueError, match="contiguous"):
        lstm_recurrence(x_proj.transpose(1, 2), mask.transpose(1, 2), R)
    with pytest.raises(ValueError, match="H=513"):
        lstm_recurrence(*_rec_inputs(2, 4, 8, 513, dev))
    X, Y, b1, W2, b2 = _head_inputs(1, 4, 4, 32, 4, dev)
    with pytest.raises(ValueError, match="shape"):
        grid_head(X, Y, b1, W2[:16], b2)


def test_fused_model_matches_plain_model(dev):
    dims = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 800}
    flat = init_relation_params(0, dims)
    g = torch.Generator().manual_seed(1)
    table = torch.randn(100, 300, generator=g).to(dev)
    I, C, L, M = 2, 8, 16, 8
    batch = {"tokens": torch.randint(1, 100, (I, C, L), generator=g),
             "tok_len": torch.randint(0, L + 1, (I, C), generator=g),
             "m_cap": torch.randint(0, 5, (I, M), generator=g),
             "m_first": torch.randint(0, 4, (I, M), generator=g),
             "m_last": torch.randint(4, 8, (I, M), generator=g),
             "pair_ij": torch.randint(0, M, (I, 28, 2), generator=g)}
    batch = {k: v.to(dev) for k, v in batch.items()}
    probs = {}
    for fused in (True, False):
        model = RelationModel(300, 200, 800, fused=fused, device=dev)
        model.load_flat(flat)
        probs[fused] = relation_predict(model, table, batch)
    err = (probs[True] - probs[False]).abs().max().item()
    assert err <= 1e-5, err


def _train_inputs(G, A, B, K, O, dev, seed=0):
    X, Y, b1, W2, b2 = _head_inputs(G, A, B, K, O, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    seeds = torch.randint(0, 2 ** 31 - 1, (G,), generator=g, device=dev,
                          dtype=torch.int32)
    labels = torch.randint(0, O, (G, A, B), generator=g, device=dev,
                           dtype=torch.int32)
    weights = ((torch.rand(G, A, B, generator=g, device=dev) > 0.25)
               * torch.where(torch.rand(G, A, B, generator=g, device=dev)
                             > 0.5, 1.0, 0.3))
    cot = torch.randn(G, A, B, O, generator=g, device=dev)
    return (X, Y, b1, W2, b2), seeds, labels, weights, cot


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("G,A,B,K,O", [
    (1, 8, 8, 800, 4), (64, 16, 16, 800, 4), (64, 32, 32, 800, 4),
    (2, 24, 40, 32, 4), (3, 9, 70, 16, 2), (2, 5, 7, 33, 3),
    # the affinity table shapes (A != B), and a head wider than the
    # backward kernel's O = 2 and O = 4 forms, over more than 16 rows
    (64, 16, 32, 1024, 2), (64, 16, 20, 1024, 2), (2, 33, 5, 70, 8),
    # ragged register tiles, K no multiple of 4, every head width, K splits
    (1, 5, 7, 30, 1), (2, 7, 9, 50, 2), (2, 9, 17, 800, 3), (1, 17, 20, 1024, 4),
    (2, 20, 33, 50, 8), (1, 16, 16, 800, 4), (4, 16, 32, 1024, 2)])
def test_grid_head_train_kernels_match_plain(dev, G, A, B, K, O, rate):
    (X, Y, b1, W2, b2), seeds, labels, weights, cot = _train_inputs(
        G, A, B, K, O, dev)
    gl = torch.tensor(0.37, device=dev)
    cases = [
        (ght.grid_head_train_fwd, (X, Y, b1, W2, b2, seeds, rate),
         ght.grid_head_train_reference),
        (ght.grid_head_train_bwd, (X, Y, b1, W2, seeds, cot, rate),
         ght.grid_head_train_bwd_plain),
        (ght.grid_head_train_loss_fwd,
         (X, Y, b1, W2, b2, seeds, labels, weights, rate),
         ght.grid_head_train_loss_reference),
        (ght.grid_head_train_loss_bwd,
         (X, Y, b1, W2, b2, seeds, labels, weights, gl, rate),
         ght.grid_head_train_loss_bwd_plain)]
    for fn, args, plain in cases:
        n0 = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        want = plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want, strict=True):
            assert a.shape == b.shape
            _assert_close(a, b)
        again = fn(*args)
        again = again if isinstance(again, tuple) else (again,)
        for a, b in zip(got, again):
            assert torch.equal(a, b)                 # bitwise repeatable


@pytest.mark.parametrize("density", [0.0, 0.19, 0.42, 1.0])
@pytest.mark.parametrize("G,A,B,K,O", [(64, 16, 16, 800, 4),
                                       (8, 16, 32, 1024, 2), (2, 9, 7, 50, 3)])
def test_grid_head_train_loss_kernels_at_weight_densities(dev, G, A, B, K, O,
                                                          density):
    """K7 and K8 skip cells of weight 0: sums and gradients still match the
    plain versions, and at density 0 they are all zero."""
    (X, Y, b1, W2, b2), seeds, labels, _, _ = _train_inputs(G, A, B, K, O,
                                                            dev)
    g = torch.Generator(device=dev).manual_seed(7)
    weights = ((torch.rand(G, A, B, generator=g, device=dev) < density)
               * torch.where(torch.rand(G, A, B, generator=g, device=dev)
                             > 0.5, 1.0, 0.3))
    gl = torch.tensor(0.37, device=dev)
    args = (X, Y, b1, W2, b2, seeds, labels, weights)
    got = (*ght.grid_head_train_loss_fwd(*args, 0.5),
           *ght.grid_head_train_loss_bwd(*args, gl, 0.5))
    want = (*ght.grid_head_train_loss_reference(*args, 0.5),
            *ght.grid_head_train_loss_bwd_plain(*args, gl, 0.5))
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape
        _assert_close(a, b)
        if density == 0.0:
            assert not a.any()
    again = (*ght.grid_head_train_loss_fwd(*args, 0.5),
             *ght.grid_head_train_loss_bwd(*args, gl, 0.5))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_grid_head_train_loss_kernels_compute_cells_of_negative_weight(dev):
    """Only cells of weight exactly 0 are skipped: a negative weight enters
    the loss sum and the gradients as in the plain versions."""
    (X, Y, b1, W2, b2), seeds, labels, weights, _ = _train_inputs(
        4, 9, 17, 800, 4, dev)
    g = torch.Generator(device=dev).manual_seed(11)
    weights = weights * torch.where(
        torch.rand(weights.shape, generator=g, device=dev) > 0.5, 1.0, -0.7)
    assert (weights < 0).any() and (weights == 0).any()
    gl = torch.tensor(0.37, device=dev)
    args = (X, Y, b1, W2, b2, seeds, labels, weights)
    got = (*ght.grid_head_train_loss_fwd(*args, 0.5),
           *ght.grid_head_train_loss_bwd(*args, gl, 0.5))
    want = (*ght.grid_head_train_loss_reference(*args, 0.5),
            *ght.grid_head_train_loss_bwd_plain(*args, gl, 0.5))
    for a, b in zip(got, want, strict=True):
        _assert_close(a, b)


def test_grid_head_train_kernels_take_an_unaligned_view(dev):
    (X, Y, b1, W2, b2), seeds, labels, weights, cot = _train_inputs(
        8, 16, 16, 800, 4, dev)
    gl = torch.tensor(0.37, device=dev)
    want = (ght.grid_head_train_reference(X, Y, b1, W2, b2, seeds, 0.5),
            *ght.grid_head_train_loss_reference(X, Y, b1, W2, b2, seeds,
                                                labels, weights, 0.5),
            *ght.grid_head_train_loss_bwd_plain(X, Y, b1, W2, b2, seeds,
                                                labels, weights, gl, 0.5))
    Yv = _offset_view(Y)
    got = (ght.grid_head_train_fwd(X, Yv, b1, W2, b2, seeds, 0.5),
           *ght.grid_head_train_loss_fwd(X, Yv, b1, W2, b2, seeds, labels,
                                         weights, 0.5),
           *ght.grid_head_train_loss_bwd(X, Yv, b1, W2, b2, seeds, labels,
                                         weights, gl, 0.5))
    for a, b in zip(got, want, strict=True):
        _assert_close(a, b)


def test_grid_head_train_empty_grid_launches_nothing(dev):
    (X, Y, b1, W2, b2), seeds, labels, weights, cot = _train_inputs(
        2, 0, 4, 800, 4, dev)
    fns = (ght.grid_head_train_fwd, ght.grid_head_train_bwd,
           ght.grid_head_train_loss_fwd, ght.grid_head_train_loss_bwd)
    n0 = [f.launches for f in fns]
    out = ght.grid_head_train_fwd(X, Y, b1, W2, b2, seeds, 0.5)
    dX, dY, dW2, db1 = ght.grid_head_train_bwd(X, Y, b1, W2, seeds, cot, 0.5)
    sums = ght.grid_head_train_loss_fwd(X, Y, b1, W2, b2, seeds, labels,
                                        weights, 0.5)
    grads = ght.grid_head_train_loss_bwd(X, Y, b1, W2, b2, seeds, labels,
                                         weights, torch.ones((), device=dev),
                                         0.5)
    assert out.shape == (2, 0, 4, 4) and dY.shape == (2, 4, 800)
    assert not dY.any() and not dW2.any() and not any(s.item() for s in sums)
    assert not any(g.any() for g in grads)
    assert [f.launches for f in fns] == n0


def test_grid_head_train_backward_rejects_a_grid_beyond_shared_memory(dev):
    (X, Y, b1, W2, b2), seeds, labels, weights, cot = _train_inputs(
        1, 130, 130, 8, 8, dev)
    with pytest.raises(ValueError, match="shared memory"):
        ght.grid_head_train_bwd(X, Y, b1, W2, seeds, cot, 0.0)
    with pytest.raises(ValueError, match="shared memory"):
        ght.grid_head_train_loss_bwd(X, Y, b1, W2, b2, seeds, labels, weights,
                                     torch.ones((), device=dev), 0.0)


def test_grid_head_train_zero_weight_cells_are_inert(dev):
    (X, Y, b1, W2, b2), seeds, labels, weights, _ = _train_inputs(
        4, 16, 16, 800, 4, dev)
    poisoned = torch.where(weights > 0, labels, 3).to(torch.int32)
    for fn, extra in ((ght.grid_head_train_loss_fwd, ()),
                      (ght.grid_head_train_loss_bwd,
                       (torch.tensor(1.3, device=dev),))):
        a = fn(X, Y, b1, W2, b2, seeds, labels, weights, *extra, 0.5)
        b = fn(X, Y, b1, W2, b2, seeds, poisoned, weights, *extra, 0.5)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("G,L,B,H", [
    (2, 32, 512, 200), (2, 16, 8, 200), (2, 9, 13, 40), (1, 7, 5, 256),
    (2, 32, 61, 200), (1, 16, 1024, 200), (2, 16, 61, 64),
    (2, 16, 61, 300), (1, 7, 5, 512),
    (2, 8, 13, 8), (2, 8, 13, 9), (2, 16, 13, 201), (1, 5, 9, 257),
    (1, 4, 9, 368), (1, 4, 9, 369), (2, 16, 1, 200), (2, 1, 13, 200)])
def test_recurrence_residuals_match_plain(dev, G, L, B, H):
    args = _rec_inputs(G, L, B, H, dev)
    hs0, fin0 = lstm_recurrence(*args)
    hs, fin, gates, c = lstm_recurrence_fwd(*args, residuals=True)
    torch.cuda.synchronize()
    assert torch.equal(hs, hs0) and torch.equal(fin, fin0)
    for a, b in zip((hs, fin, gates, c),                # bitwise repeatable
                    lstm_recurrence_fwd(*args, residuals=True)):
        assert torch.equal(a, b)
    want = lstm_recurrence_reference(*args, residuals=True)
    for got, ref in zip((hs, fin, gates, c), want, strict=True):
        _assert_close(got, ref)


def _bwd_inputs(G, L, B, H, dev, which="both", seed=0):
    """The backward's arguments: the forward kernel's residuals over
    _rec_inputs (a length-0 row, a full row, the rest ragged) and random
    cotangents, `which` of them non-zero ("both", "dhs" or "dhf")."""
    x_proj, mask, R = _rec_inputs(G, L, B, H, dev, seed)
    hs, _, gates, c = lstm_recurrence_fwd(x_proj, mask, R, residuals=True)
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    dhs = torch.randn(G, L, B, H, generator=g, device=dev)
    dhf = torch.randn(G, B, H, generator=g, device=dev)
    if which == "dhs":
        dhf.zero_()
    elif which == "dhf":
        dhs.zero_()
    return gates, c, hs, R, mask, dhs, dhf


def _check_bwd_kernel(args):
    n0 = lstm_recurrence.bwd.launches
    got = lstm_recurrence_bwd_kernel(*args)
    torch.cuda.synchronize()
    assert lstm_recurrence.bwd.launches == n0 + 1
    for g, w in zip(got, lstm_recurrence_bwd(*args), strict=True):
        _assert_close(g, w)
    for g, w in zip(got, lstm_recurrence_bwd_kernel(*args)):
        assert torch.equal(g, w)                   # bitwise repeatable


# the train steps' shapes (the relation BiLSTM at L = 16 and 32, B = 320;
# the affinity phrase LSTM at B = 1024), one row, a lone tile; H = 200 and
# 256 on the 8-block cluster, 300 on the 16-block one with R on chip, 512
# with R read from device memory
@pytest.mark.parametrize("H", [200, 256, 300, 512])
@pytest.mark.parametrize("B", [1, 7, 320, 1024])
@pytest.mark.parametrize("L", [1, 16, 32])
@pytest.mark.parametrize("G", [1, 2])
def test_recurrence_bwd_kernel_matches_plain(dev, G, L, B, H):
    _check_bwd_kernel(_bwd_inputs(G, L, B, H, dev))


# only dhs or only dhf non-zero; ragged blocks (H = 1, 9, 201, 257); the
# widths about where R leaves shared memory (368, 416, 417); two steps
@pytest.mark.parametrize("which", ["dhs", "dhf", "both"])
@pytest.mark.parametrize("G,L,B,H", [
    (2, 16, 61, 200), (2, 2, 17, 200), (2, 3, 9, 1), (2, 8, 13, 9),
    (2, 16, 13, 201), (1, 5, 9, 257), (1, 4, 9, 368), (2, 4, 9, 416),
    (2, 4, 9, 417), (2, 48, 37, 64)])
def test_recurrence_bwd_kernel_edges(dev, G, L, B, H, which):
    _check_bwd_kernel(_bwd_inputs(G, L, B, H, dev, which))


def test_recurrence_bwd_kernel_empty_and_rejects(dev):
    n0 = lstm_recurrence.bwd.launches
    for G, L, B in ((2, 0, 5), (2, 4, 0)):
        args = _bwd_inputs(G, L, B, 16, dev)
        dg, dR = lstm_recurrence_bwd_kernel(*args)
        assert dg.shape == (G, L, B, 64) and dR.shape == (G, 16, 64)
        assert not dR.any()
    assert lstm_recurrence.bwd.launches == n0
    gates, c, hs, R, mask, dhs, dhf = _bwd_inputs(2, 4, 8, 16, dev)
    with pytest.raises(TypeError, match="bfloat16"):
        lstm_recurrence_bwd_kernel(gates.bfloat16(), c, hs, R, mask, dhs,
                                   dhf)
    with pytest.raises(ValueError, match="contiguous"):
        lstm_recurrence_bwd_kernel(gates, c, hs, R, mask,
                                   dhs.transpose(2, 3).contiguous()
                                   .transpose(2, 3), dhf)
    assert lstm_recurrence.bwd.launches == n0


BWD_BF16_UNITS = 8   # the bf16 backward vs its plain loop (dx_proj, dR)


# the bf16 mode (--compute_dtype bf16) at the train steps' shapes, past 256
# units (R on chip, and from device memory at 512) and at small ragged H
@pytest.mark.parametrize("G,L,B,H", [
    (2, 32, 320, 200), (2, 16, 320, 200), (1, 16, 1024, 200),
    (2, 16, 61, 256), (2, 16, 61, 300), (2, 8, 13, 512), (2, 8, 13, 9),
    (2, 3, 9, 1), (2, 1, 7, 200)])
def test_recurrence_bwd_kernel_bf16_matches_plain(dev, G, L, B, H):
    args = [t.bfloat16() if t.is_floating_point() else t
            for t in _bwd_inputs(G, L, B, H, dev)]
    n0, n1 = lstm_recurrence.bwd.launches, lstm_recurrence.bwd_bf16.launches
    got = lstm_recurrence_bwd_kernel(*args)
    torch.cuda.synchronize()
    assert (lstm_recurrence.bwd.launches,
            lstm_recurrence.bwd_bf16.launches) == (n0, n1 + 1)
    for name, g, w in zip(("dx_proj", "dR"), got, lstm_recurrence_bwd(*args),
                          strict=True):
        assert g.dtype == torch.bfloat16
        assert bf16_units((w,), (g,)) <= BWD_BF16_UNITS, name
    for g, w in zip(got, lstm_recurrence_bwd_kernel(*args)):
        assert torch.equal(g, w)                   # bitwise repeatable


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recurrence_backward_launches_one_kernel(dev, dtype):
    """LSTMRecurrence.backward on the card: one launch of the backward
    kernel (its bf16 mode in bf16), no eager per-step launches (the
    profiler's kernel count)."""
    x_proj, mask, R = _rec_inputs(2, 32, 320, 200, dev)
    x_proj = x_proj.to(dtype).requires_grad_()
    R = R.to(dtype).requires_grad_()
    hs, fin = lstm_recurrence(x_proj, mask, R)
    torch.cuda.synchronize()
    counts = (lstm_recurrence.bwd, lstm_recurrence.bwd_bf16)
    n0 = [c.launches for c in counts]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        (hs.float().sum() + fin.float().sum()).backward()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    bf16 = dtype == torch.bfloat16
    assert [c.launches for c in counts] == [n0[0] + (not bf16),
                                            n0[1] + bf16]
    assert kernels < 40, kernels           # the loop made ~35 a step


def _relation_batch(dev):
    """A word table and a 4-image relation batch (8 captions of up to 16
    tokens, 8 mentions, every pair)."""
    g = torch.Generator().manual_seed(1)
    table = torch.randn(100, 300, generator=g).to(dev)
    I, C, L, M = 4, 8, 16, 8
    iu, ju = torch.triu_indices(M, M, 1)
    P = iu.numel()
    batch = {"tokens": torch.randint(1, 100, (I, C, L), generator=g),
             "tok_len": torch.randint(0, L + 1, (I, C), generator=g),
             "m_cap": torch.randint(0, 5, (I, M), generator=g),
             "m_first": torch.randint(0, 4, (I, M), generator=g),
             "m_last": torch.randint(4, 8, (I, M), generator=g),
             "pair_ij": torch.stack([iu, ju], 1).expand(I, P, 2),
             "pair_label": torch.randint(0, 4, (I, P), generator=g),
             "pair_valid": torch.rand(I, P, generator=g) < 0.9}
    return table, {k: v.contiguous().to(dev) for k, v in batch.items()}


def test_relation_train_steps_count_one_backward_kernel_a_step(dev):
    """``lstm.bwd.kernel`` against ``icl.train.step`` under a profile: the
    BiLSTM's backward engages the kernel once a step, the steps replaying
    their CUDA graph (captured outside the profile), where no host span of
    the backward is left."""
    from icl_torch.train.state import create_train_state
    from icl_torch.train.steps import make_relation_train_step
    from icl_torch.util import trace

    table, batch = _relation_batch(dev)
    model = RelationModel(300, 200, 800, fused=True, dropout=0.5, device=dev)
    state = create_train_state(model, seed=5)
    step = make_relation_train_step(class_weights=[0.3, 1, 1, 1],
                                    grid_loss=True)
    for _ in range(2):                  # eager, then the capture
        step(state, table, batch)                   # outside the profile
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            step(state, table, batch)
        torch.cuda.synchronize()
    snap = trace.snapshot()
    trace.reset()
    assert snap["spans"]["icl.train.step"]["count"] == 3
    assert "icl.lstm.backward" not in snap["spans"]
    assert snap["counters"]["lstm.bwd.kernel"] == 3
    assert snap["counters"]["train.graph.replay"] == 3


@pytest.mark.parametrize("grid_loss", [True, False])
def test_train_loss_and_grads_kernel_path_match_plain(dev, grid_loss):
    dims = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 800}
    flat = init_relation_params(0, dims)
    table, batch = _relation_batch(dev)
    seeds = torch.tensor([3, 5, 7, 9], dtype=torch.int32, device=dev)
    cw = torch.tensor([0.3, 1.0, 1.0, 1.0], device=dev)
    out = {}
    for fused in (True, False):
        model = RelationModel(300, 200, 800, fused=fused, dropout=0.5,
                              device=dev)
        model.load_flat(flat)
        loss, metrics = relation_loss(model, table, batch, seeds, cw,
                                      grid_loss)
        n0 = lstm_recurrence.bwd.launches
        loss.backward()
        # the kernel path's BiLSTM backward is one launch of the kernel
        assert lstm_recurrence.bwd.launches == n0 + fused
        out[fused] = (metrics, {k: p.grad for k, p in
                                model.named_parameters()})
    for k in out[False][0]:
        _assert_close(out[True][0][k], out[False][0][k])
    for k, want in out[False][1].items():
        _assert_close(out[True][1][k], want)


# --- affinity: K9 and the affinity model --------------------------------------

def _rank_inputs(G, A, B, K, dev, seed=0):
    args = _head_inputs(G, A, B, K, 2, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    valid = torch.rand(G, B, generator=g, device=dev) < 0.7
    valid[:, 0] = True
    if G > 1:
        valid[-1] = False                           # an image with no box
    return (*args, valid.contiguous())


@pytest.mark.parametrize("G,A,B,K", [
    (1, 8, 8, 1024), (4, 16, 32, 1024), (64, 16, 32, 1024),
    (64, 16, 20, 1024), (3, 5, 70, 33), (2, 7, 3, 16),
    # the tile routine: B in {1, 20, 32, 33, 100}, A in {1, 12, 16, 17},
    # K % 4 != 0, more boxes than a block's 8 column tiles
    (2, 12, 1, 1024), (3, 1, 20, 1024), (2, 17, 33, 1024),
    (2, 12, 100, 1024), (5, 16, 32, 1022), (2, 9, 20, 30), (2, 7, 300, 800)])
def test_affinity_rank_kernel_matches_plain(dev, G, A, B, K):
    args = _rank_inputs(G, A, B, K, dev)
    n0 = affinity_rank.launches
    out = affinity_rank(*args)
    torch.cuda.synchronize()
    assert affinity_rank.launches == n0 + 1
    _assert_close(out, affinity_rank_reference(*args))
    valid = args[-1][:, None, :].expand_as(out)
    assert not out[~valid].any()                    # invalid boxes: exact 0
    if G > 1:
        assert not out[-1].any()                    # no valid box: zeros
    assert torch.equal(out, affinity_rank(*args))   # bitwise repeatable


@pytest.mark.parametrize("which", [0, 1, 2, 3])
@pytest.mark.parametrize("G", [4, 64])
def test_affinity_rank_kernel_takes_an_unaligned_view(dev, G, which):
    """One of X, Y, b1, W2 only 4-byte aligned: 4-byte loads, same values."""
    args = list(_rank_inputs(G, 16, 32, 1024, dev))
    want = affinity_rank_reference(*args)
    args[which] = _offset_view(args[which])
    out = affinity_rank(*args)
    _assert_close(out, want)
    assert torch.equal(out, affinity_rank(*args))


@pytest.mark.parametrize("O,col", [(2, 0), (3, 2), (4, 1)])
def test_affinity_rank_kernel_takes_any_column(dev, O, col):
    X, Y, b1, _, _, valid = _rank_inputs(3, 9, 20, 1024, dev)
    _, _, _, W2, b2 = _head_inputs(3, 9, 20, 1024, O, dev, seed=5)
    out = affinity_rank(X, Y, b1, W2, b2, valid, affinity_col=col)
    _assert_close(out, affinity_rank_reference(X, Y, b1, W2, b2, valid, col))


def test_predict_kernels_refuse_a_call_under_grad(dev):
    from icl_torch.ops.grid_head import KernelNoGradError

    X, Y, b1, W2, b2, valid = _rank_inputs(2, 4, 8, 64, dev)
    W2.requires_grad_()
    with pytest.raises(KernelNoGradError, match="grid_head"):
        grid_head(X, Y, b1, W2, b2)
    with pytest.raises(KernelNoGradError, match="affinity_rank"):
        affinity_rank(X, Y, b1, W2, b2, valid)
    with torch.inference_mode():
        grid_head(X, Y, b1, W2, b2)
        affinity_rank(X, Y, b1, W2, b2, valid)


def test_affinity_rank_empty_grid_and_rejects(dev):
    n0 = affinity_rank.launches
    out = affinity_rank(*_rank_inputs(2, 0, 5, 64, dev))
    assert out.shape == (2, 0, 5) and affinity_rank.launches == n0
    X, Y, b1, W2, b2, valid = _rank_inputs(2, 3, 5, 64, dev)
    with pytest.raises(TypeError, match="box_valid"):
        affinity_rank(X, Y, b1, W2, b2, valid.int())
    with pytest.raises(ValueError, match="affinity_col"):
        affinity_rank(X, Y, b1, W2, b2, valid, affinity_col=2)


AFF_DIMS = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 1024,
            "box_dim": 4096}


def _affinity_batch(dev, I=4, M=16, B=32, L=16):
    g = torch.Generator().manual_seed(2)
    plen = torch.randint(0, 9, (I, M), generator=g)
    box_valid = torch.arange(B)[None] < torch.tensor([20, 5, 1, 0])[:, None]
    batch = {"phrase_tokens": torch.randint(1, 100, (I, M, L), generator=g),
             "phrase_len": plen.to(torch.int32),
             "box_feats": torch.relu(torch.randn(I, B, 4096, generator=g)),
             "box_valid": box_valid,
             "grid_label": torch.randint(0, 2, (I, M, B), generator=g),
             "grid_valid": (plen > 0)[..., None] & box_valid[:, None, :]}
    table = torch.randn(100, 300, generator=g).to(dev)
    return table, {k: v.contiguous().to(dev) for k, v in batch.items()}


def test_fused_affinity_model_matches_plain_model(dev):
    flat = init_params("affinity", 0, AFF_DIMS)
    table, batch = _affinity_batch(dev)
    out = {}
    for fused in (True, False):
        model = AffinityModel(**AFF_DIMS, fused=fused, device=dev)
        model.load_flat(flat)
        out[fused] = affinity_predict(model, table, batch, rank=True)
    for got, want in zip(out[True], out[False]):
        assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("grid_loss", [True, False])
def test_affinity_train_kernel_path_matches_plain(dev, grid_loss):
    flat = init_params("affinity", 0, AFF_DIMS)
    table, batch = _affinity_batch(dev)
    seeds = torch.tensor([3, 5, 7, 9], dtype=torch.int32, device=dev)
    out = {}
    for fused in (True, False):
        model = AffinityModel(**AFF_DIMS, fused=fused, dropout=0.5,
                              device=dev)
        model.load_flat(flat)
        loss, metrics = affinity_loss(model, table, batch, seeds, None,
                                      grid_loss)
        n0 = lstm_recurrence.bwd.launches
        loss.backward()
        assert lstm_recurrence.bwd.launches == n0 + fused
        out[fused] = (metrics, {k: p.grad for k, p in
                                model.named_parameters()})
    for k in out[False][0]:
        _assert_close(out[True][0][k], out[False][0][k])
    for k, want in out[False][1].items():
        _assert_close(out[True][1][k], want)


# --- the bf16 modes (--compute_dtype bf16) ----------------------------------

# the fast dot: the relation and affinity batches, ragged tiles, K % 4 != 0,
# every O; and the tensor-core routine's edges: K no multiple of 16 (a last
# chunk read +0 past K), K < 16, O from 1 to 8 (N padded to 8), A and B
# off the 8 x 16 warp tile, B <= 8 (8 boxes of two mentions an m-tile),
# the small grids that split K (G = 1 to 8) and the large ones that do
# not, more box tiles than a block's 16, shared memory past 48 KB
FAST_DOT_SHAPES = [
    (64, 16, 16, 800, 4), (64, 16, 32, 1024, 2), (8, 16, 16, 800, 4),
    (2, 9, 17, 800, 3), (2, 7, 9, 50, 2), (2, 20, 33, 50, 8),
    (1, 5, 7, 30, 1), (64, 16, 16, 792, 4), (3, 9, 17, 24, 1),
    (2, 5, 8, 72, 3), (1, 17, 33, 72, 8), (4, 3, 3, 8, 2), (1, 1, 1, 1, 5),
    (2, 12, 5, 40, 6), (5, 33, 19, 200, 7), (1, 16, 16, 800, 4),
    (8, 16, 8, 800, 4), (64, 32, 32, 800, 4), (128, 16, 32, 1024, 2),
    (2, 9, 300, 64, 4), (64, 16, 32, 2048, 2)]


@pytest.mark.parametrize("G,A,B,K,O", FAST_DOT_SHAPES + [(1, 4, 100, 4100, 2)])
def test_grid_head_fast_dot_matches_plain(dev, G, A, B, K, O):
    """The fast-dot mode against its plain version, the f32 gate: both
    round the same activation and W2 to bf16 and sum exact products in
    f32.  Its launches count apart from the f32 entry point's."""
    args = _head_inputs(G, A, B, K, O, dev)
    n0, n1 = grid_head.launches, grid_head.bf16dot.launches
    m1 = grid_head.bf16dot.mma_launches
    out = grid_head(*args, fast_dot=True)
    torch.cuda.synchronize()
    assert (grid_head.launches, grid_head.bf16dot.launches) == (n0, n1 + 1)
    mma = gh.dot_plan(G, A, B, K, O, gh.aligned16(*args[:3])).mma
    assert grid_head.bf16dot.mma_launches == m1 + mma
    _assert_close(out, grid_head_reference(*args, fast_dot=True))
    assert torch.equal(out, grid_head(*args, fast_dot=True))
    assert not torch.equal(out, grid_head(*args))   # it is another mode


@pytest.mark.parametrize("mma", [True, False])
@pytest.mark.parametrize("G,A,B,K,O", FAST_DOT_SHAPES)
def test_grid_head_fast_dot_forms_match_plain(dev, G, A, B, K, O, mma):
    """Each form of the fast dot at every shape, whichever dot_plan would
    pick there: the tensor cores (mma) and the FMA form.  The f32 gate,
    two calls equal bits."""
    args = _head_inputs(G, A, B, K, O, dev)
    out, again = (torch.empty((G, A, B, O), device=dev) for _ in range(2))
    gh._fast_dot(*args, out, mma)
    gh._fast_dot(*args, again, mma)
    torch.cuda.synchronize()
    _assert_close(out, grid_head_reference(*args, fast_dot=True))
    assert torch.equal(out, again)


@pytest.mark.parametrize("mma", [True, False])
@pytest.mark.parametrize("which", [0, 1, 2, 3])
@pytest.mark.parametrize("G,A,B,K,O", [(8, 16, 16, 800, 4),
                                       (3, 9, 6, 72, 3)])
def test_grid_head_fast_dot_takes_an_unaligned_view(dev, G, A, B, K, O,
                                                    which, mma):
    """One of X, Y, b1, W2 only 4-byte aligned, in each form: 4-byte
    loads, same values."""
    args = list(_head_inputs(G, A, B, K, O, dev))
    want = grid_head_reference(*args, fast_dot=True)
    args[which] = _offset_view(args[which])
    out, again = (torch.empty((G, A, B, O), device=dev) for _ in range(2))
    gh._fast_dot(*args, out, mma)
    gh._fast_dot(*args, again, mma)
    _assert_close(out, want)
    assert torch.equal(out, again)


def test_grid_head_fast_dot_reads_nothing_past_k(dev):
    """K = 24 on the tensor cores: the last chunk's slots past K are +0 in
    W2's fragments however W2 continues in memory; a NaN there stays
    out."""
    X, Y, b1, W2, b2 = _head_inputs(2, 9, 17, 24, 4, dev)
    wide = torch.full((32, 4), float("nan"), device=dev)
    wide[:24] = W2
    out = torch.empty((2, 9, 17, 4), device=dev)
    gh._fast_dot(X, Y, b1, wide[:24], b2, out, True)
    assert torch.isfinite(out).all()
    _assert_close(out, grid_head_reference(X, Y, b1, W2, b2, fast_dot=True))


@pytest.mark.parametrize("G,moved", [(4, None), (64, None), (4, 1)])
def test_affinity_rank_fast_dot_matches_plain(dev, G, moved):
    args = list(_rank_inputs(G, 16, 32, 1024, dev))
    want = affinity_rank_reference(*args, 1, True)
    if moved is not None:
        args[moved] = _offset_view(args[moved])
    n0 = affinity_rank.bf16dot.launches
    m0 = affinity_rank.bf16dot.mma_launches
    out = affinity_rank(*args, fast_dot=True)
    torch.cuda.synchronize()
    assert affinity_rank.bf16dot.launches == n0 + 1
    # the batch on the tensor cores, the served request in the FMA form
    assert affinity_rank.bf16dot.mma_launches == m0 + (G == 64)
    _assert_close(out, want)
    assert torch.equal(out, affinity_rank(*args, fast_dot=True))


@pytest.mark.parametrize("G,A,B,K,O,col", [
    (1, 8, 8, 1024, 2, 1), (2, 7, 3, 16, 2, 1), (3, 5, 70, 33, 2, 1),
    (2, 12, 1, 1024, 2, 1), (3, 1, 20, 1024, 2, 0), (2, 17, 33, 1024, 2, 1),
    (2, 12, 100, 1024, 2, 1), (5, 16, 32, 1022, 2, 1), (2, 9, 20, 30, 3, 2),
    (2, 7, 300, 800, 4, 3), (3, 9, 5, 72, 2, 1), (4, 3, 9, 24, 1, 0),
    (2, 6, 200, 1024, 2, 1), (64, 16, 32, 1024, 2, 1), (32, 17, 20, 800, 2, 1)])
@pytest.mark.parametrize("form", ["mma", "fma"])
def test_affinity_rank_fast_dot_edges(dev, G, A, B, K, O, col, form):
    """The ranking over the fast dot in each form at the tensor-core
    routine's edges: B <= 8, B past 16 tiles of 16 boxes (turns), A off
    the group of 8 mentions, K no multiple of 16, any column of any W2
    width.  Invalid boxes exactly 0, an image with no valid box a row of
    zeros, two calls equal bits."""
    X, Y, b1, _, _, valid = _rank_inputs(G, A, B, K, dev)
    _, _, _, W2, b2 = _head_inputs(G, A, B, K, O, dev, seed=5)
    args = (X, Y, b1, W2, b2, valid)
    out, again = (torch.empty((G, A, B), device=dev) for _ in range(2))
    ar._launch(*args, out, col, form)
    ar._launch(*args, again, col, form)
    torch.cuda.synchronize()
    _assert_close(out, affinity_rank_reference(*args, col, True))
    assert not out[~valid[:, None, :].expand_as(out)].any()
    if G > 1:
        assert not out[-1].any()
    assert torch.equal(out, again)


@pytest.mark.parametrize("G,L,B,H", [
    (2, 32, 64, 200), (2, 32, 320, 200), (1, 16, 1024, 200),
    (2, 16, 61, 63), (1, 8, 9, 255), (2, 3, 9, 1), (2, 16, 61, 300),
    (1, 8, 9, 511), (2, 8, 9, 16), (2, 16, 17, 368), (2, 16, 17, 369),
    (2, 16, 61, 512), (2, 8, 1, 200), (2, 1, 64, 200)])
def test_bf16_recurrence_matches_plain(dev, G, L, B, H):
    """The bf16 mode (h . R on the tensor cores) against the plain
    version's eager bf16 ops: within 4 bf16 units of max |plain| (the order
    of the h . R sum moves a rounded value by a unit now and then); odd
    widths, one k-step, both sides of 368, 512, one row and one step."""
    x_proj, mask, R = _rec_inputs(G, L, B, H, dev)
    args = (x_proj.bfloat16(), mask, R.bfloat16())
    n0, n1 = lstm_recurrence.launches, lstm_recurrence.bf16.launches
    got = lstm_recurrence_fwd(*args, residuals=True)
    torch.cuda.synchronize()
    assert (lstm_recurrence.launches, lstm_recurrence.bf16.launches) == (
        n0, n1 + 1)
    for g, w in zip(got, lstm_recurrence_reference(*args, True)):
        assert g.dtype == torch.bfloat16
        w = w.float()
        unit = 2.0 ** (int(torch.log2(w.abs().max()).floor()) - 7)
        assert (g.float() - w).abs().max().item() <= 4 * unit
    again = lstm_recurrence_fwd(*args, residuals=True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# --- the one-pass bf16 mode of K5-K8 (--matmul_precision default|high) ------

def _onepass_loss_bwd_matches_plain(X, Y, b1, W2, b2, seeds, labels, weights,
                                    gl, rate):
    """K8 in the one-pass mode, held in its two halves: its logit gradient
    g3 against the plain version's (the one-pass logits, f32 CE, nothing
    rounded after them), and its gradients against the plain backward of
    that same g3.  Fed the plain g3 instead, the backward would round a g3
    that the logits' f32 sum order moved by a unit to the neighbouring
    bf16 value now and then."""
    G, A, B = labels.shape
    g3 = torch.empty(G, A, B, W2.shape[1], device=X.device)
    got = ght.grid_head_train_loss_bwd(X, Y, b1, W2, b2, seeds, labels,
                                       weights, gl, rate, False, g3_out=g3)
    _assert_close(g3, ght.grid_head_train_dlogits_plain(
        X, Y, b1, W2, b2, seeds, labels, weights, gl, rate, False))
    want = (*ght.grid_head_train_bwd_plain(X, Y, b1, W2, seeds, g3, rate,
                                           False), g3.sum((0, 1, 2)))
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape
        _assert_close(a, b)
    return got


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("G,A,B,K,O", [
    (1, 8, 8, 800, 4), (64, 16, 16, 800, 4), (64, 32, 32, 800, 4),
    (64, 16, 32, 1024, 2), (64, 16, 20, 1024, 2), (2, 33, 5, 70, 8),
    (1, 5, 7, 30, 1), (2, 7, 9, 50, 2), (2, 9, 17, 800, 3),
    (2, 20, 33, 50, 8), (4, 16, 32, 1024, 2)])
def test_grid_head_train_onepass_kernels_match_plain(dev, G, A, B, K, O,
                                                     rate):
    """Each one-pass entry point against its plain version (exact=False),
    the f32 gate: both round the same f32 values to bf16, so only the order
    of the f32 sums differs (K8 in its two halves).  Twice with equal bits;
    the launches count apart from the f32 entry points'; the mode differs
    from exact f32 (but for the CE of a one-class head, 0 in both)."""
    (X, Y, b1, W2, b2), seeds, labels, weights, cot = _train_inputs(
        G, A, B, K, O, dev)
    gl = torch.tensor(0.37, device=dev)
    cases = [
        (ght.grid_head_train_fwd, (X, Y, b1, W2, b2, seeds, rate),
         ght.grid_head_train_reference),
        (ght.grid_head_train_bwd, (X, Y, b1, W2, seeds, cot, rate),
         ght.grid_head_train_bwd_plain),
        (ght.grid_head_train_loss_fwd,
         (X, Y, b1, W2, b2, seeds, labels, weights, rate),
         ght.grid_head_train_loss_reference),
        (ght.grid_head_train_loss_bwd,
         (X, Y, b1, W2, b2, seeds, labels, weights, gl, rate),
         ght.grid_head_train_loss_bwd_plain)]
    for fn, args, plain in cases:
        n0, n1 = fn.launches, fn.onepass.launches
        if fn is ght.grid_head_train_loss_bwd:
            got = _onepass_loss_bwd_matches_plain(*args)
        else:
            got = fn(*args, False)
            got = got if isinstance(got, tuple) else (got,)
            want = plain(*args, False)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want, strict=True):
                assert a.shape == b.shape
                _assert_close(a, b)
        torch.cuda.synchronize()
        assert (fn.launches, fn.onepass.launches) == (n0, n1 + 1)
        again = fn(*args, False)
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        if O == 1 and fn in (ght.grid_head_train_loss_fwd,
                             ght.grid_head_train_loss_bwd):
            continue    # the CE of one class is 0 in both modes
        exact = fn(*args)
        exact = exact if isinstance(exact, tuple) else (exact,)
        assert not all(torch.equal(a, b) for a, b in zip(got, exact))


@pytest.mark.parametrize("density", [0.0, 0.19, 1.0])
@pytest.mark.parametrize("G,A,B,K,O", [(64, 16, 16, 800, 4),
                                       (8, 16, 32, 1024, 2)])
def test_grid_head_train_onepass_loss_kernels_at_weight_densities(
        dev, G, A, B, K, O, density):
    (X, Y, b1, W2, b2), seeds, labels, _, _ = _train_inputs(G, A, B, K, O,
                                                            dev)
    g = torch.Generator(device=dev).manual_seed(7)
    weights = ((torch.rand(G, A, B, generator=g, device=dev) < density)
               * torch.where(torch.rand(G, A, B, generator=g, device=dev)
                             > 0.5, 1.0, 0.3))
    gl = torch.tensor(0.37, device=dev)
    args = (X, Y, b1, W2, b2, seeds, labels, weights)
    got = ght.grid_head_train_loss_fwd(*args, 0.5, False)
    for a, b in zip(got, ght.grid_head_train_loss_reference(*args, 0.5, False),
                    strict=True):
        _assert_close(a, b)
    got = (*got, *_onepass_loss_bwd_matches_plain(*args, gl, 0.5))
    if density == 0.0:
        assert not any(a.any() for a in got)


# --- the backward walks only the cells with a cotangent ---------------------

@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("G,A,B,K,O", [(2, 17, 20, 1024, 2),
                                       (2, 17, 20, 800, 4), (3, 9, 7, 50, 3)])
def test_loss_backward_with_one_live_cell_in_every_other_row_group(
        dev, G, A, B, K, O, rate, exact):
    """K8 with weights zero but for one cell in groups 0, 2, ... of four
    rows (the walk lists one cell there and none in the other groups):
    its gradients against the plain version's (the one-pass mode in its two
    halves), twice with equal bits."""
    from icl_torch.tools.kernel_bits import one_cell_groups

    (X, Y, b1, W2, b2), seeds, labels, _, _ = _train_inputs(G, A, B, K, O,
                                                            dev)
    weights = one_cell_groups(G, A, B, torch.Generator(
        device=dev).manual_seed(5), dev)
    args = (X, Y, b1, W2, b2, seeds, labels, weights,
            torch.tensor(0.37, device=dev), rate)
    if exact:
        got = ght.grid_head_train_loss_bwd(*args)
        for a, b in zip(got, ght.grid_head_train_loss_bwd_plain(*args),
                        strict=True):
            _assert_close(a, b)
    else:
        got = _onepass_loss_bwd_matches_plain(*args)
    again = ght.grid_head_train_loss_bwd(*args, exact)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dX = got[0]
    live_rows = weights.sum(2) > 0                        # [G, A]
    assert not dX[~live_rows].any() and dX[live_rows].abs().sum(-1).all()


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("G,A,B,K,O", [(64, 16, 16, 800, 4),
                                       (8, 16, 32, 1024, 2), (2, 33, 5, 70, 8)])
def test_backward_with_a_cotangent_zero_at_weight_0(dev, G, A, B, K, O, rate,
                                                    exact):
    """K6 with a cotangent that is zero (of either sign) on the cells of
    weight 0, as the pair and cell forms give it: against the plain
    version, twice with equal bits."""
    (X, Y, b1, W2, _), seeds, _, weights, cot = _train_inputs(G, A, B, K, O,
                                                              dev)
    cot = cot * (weights > 0)[..., None]       # -0 where cot < 0
    assert (cot == 0).any() and torch.signbit(cot[cot == 0]).any()
    args = (X, Y, b1, W2, seeds, cot, rate, exact)
    got = ght.grid_head_train_bwd(*args)
    for a, b in zip(got, ght.grid_head_train_bwd_plain(*args), strict=True):
        _assert_close(a, b)
    assert all(torch.equal(a, b)
               for a, b in zip(got, ght.grid_head_train_bwd(*args)))


@pytest.mark.parametrize("grid_loss", [True, False])
def test_onepass_train_step_launches_only_the_onepass_kernels(dev, grid_loss):
    """A relation train step of a model with exact=False launches the
    one-pass K7/K8 (grid loss) or K5/K6 (pair form) and no f32 training
    kernel."""
    dims = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 800}
    flat = init_relation_params(0, dims)
    g = torch.Generator().manual_seed(1)
    table = torch.randn(100, 300, generator=g).to(dev)
    I, C, L, M = 4, 8, 16, 8
    iu, ju = torch.triu_indices(M, M, 1)
    P = iu.numel()
    batch = {"tokens": torch.randint(1, 100, (I, C, L), generator=g),
             "tok_len": torch.randint(0, L + 1, (I, C), generator=g),
             "m_cap": torch.randint(0, 5, (I, M), generator=g),
             "m_first": torch.randint(0, 4, (I, M), generator=g),
             "m_last": torch.randint(4, 8, (I, M), generator=g),
             "pair_ij": torch.stack([iu, ju], 1).expand(I, P, 2),
             "pair_label": torch.randint(0, 4, (I, P), generator=g),
             "pair_valid": torch.rand(I, P, generator=g) < 0.9}
    batch = {k: v.contiguous().to(dev) for k, v in batch.items()}
    seeds = torch.tensor([3, 5, 7, 9], dtype=torch.int32, device=dev)
    cw = torch.tensor([0.3, 1.0, 1.0, 1.0], device=dev)
    kernels = [ght.grid_head_train_fwd, ght.grid_head_train_bwd,
               ght.grid_head_train_loss_fwd, ght.grid_head_train_loss_bwd]
    before = [(k.launches, k.onepass.launches) for k in kernels]
    model = RelationModel(300, 200, 800, fused=True, dropout=0.5, device=dev,
                          exact=False)
    model.load_flat(flat)
    loss, metrics = relation_loss(model, table, batch, seeds, cw, grid_loss)
    loss.backward()
    torch.cuda.synchronize()
    after = [(k.launches, k.onepass.launches) for k in kernels]
    used = (2, 3) if grid_loss else (0, 1)
    for i, ((f0, o0), (f1, o1)) in enumerate(zip(before, after)):
        assert f1 == f0
        assert o1 == o0 + (1 if i in used else 0)
    assert torch.isfinite(loss)


def test_device_ms_times_by_cuda_events_when_the_profiler_traces_nothing(
        dev, monkeypatch, capsys):
    """chip_smoke.py's device times: three empty profiler windows (seen on
    a fresh machine) fall back to CUDA events, and say so."""
    from icl_torch.tools import kernel_bits

    args = _head_inputs(8, 16, 16, 800, 4, dev)
    monkeypatch.setattr(kernel_bits, "device_rows", lambda fn, iters: [])
    ms = kernel_bits.device_ms(lambda: grid_head(*args))
    assert 0 < ms < 10
    assert "timed by CUDA events" in capsys.readouterr().err
