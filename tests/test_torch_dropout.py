"""The port's dropout in training (CPU, port only).

The keep mask is a pure function of (seed, a, b, k) and keeps 1 - rate of
the cells; the fused forms (grid head, grid loss) and the gather form give
one loss at any rate, because the gather applies the mask at the pair's
cell; and the training heads' custom backward formulas (what the CPU runs
in place of the K6/K8 kernels) match autograd through the materialised
masked expression.
"""

import numpy as np
import pytest
import torch

from icl_torch.models.relation import RelationModel
from icl_torch.ops import grid_head_train as ght
from icl_torch.ops.lstm_recurrence import (lstm_recurrence,
                                           lstm_recurrence_reference)
from icl_torch.params import init_relation_params
from icl_torch.train import steps

GATE = 1e-5


def _close(got, want, what=""):
    tol = GATE * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, (what, err, tol)


def test_keep_mask_is_a_pure_function_of_seed_and_cell():
    seeds = torch.tensor([7, -3, 2 ** 31 - 2, 0], dtype=torch.int32)
    big = ght.dropout_keep_mask(seeds, 9, 11, 40, 0.5)
    # another grid size, another order of images: the same cells agree
    small = ght.dropout_keep_mask(seeds.flip(0), 4, 6, 25, 0.5)
    assert torch.equal(small, big.flip(0)[:, :4, :6, :25])
    # single cells addressed one by one (the gather form's view)
    a, b = torch.tensor([3, 0, 8]), torch.tensor([10, 5, 1])
    cells = ght.keep_mask(seeds[1].expand(3), a, b, 40, 0.5)
    assert torch.equal(cells, big[1, a, b])
    # the bits follow the formula of the kernels' source, in Python ints
    def h32(x):
        x = (((x >> 16) ^ x) * 0x45D9F3B) & 0xFFFFFFFF
        x = (((x >> 16) ^ x) * 0x45D9F3B) & 0xFFFFFFFF
        return (x >> 16) ^ x
    for g, ai, bi, k in [(1, 3, 10, 39), (2, 0, 0, 0), (0, 8, 7, 17)]:
        s = int(seeds[g]) & 0xFFFFFFFF
        bits = h32(h32(h32(h32(s) ^ ai) ^ bi) ^ k)
        assert bool(big[g, ai, bi, k]) == (bits >= 2 ** 31)
    # rate 0 keeps everything; another seed gives another mask
    assert ght.dropout_keep_mask(seeds, 3, 3, 8, 0.0).all()
    other = ght.dropout_keep_mask(seeds + 1, 9, 11, 40, 0.5)
    assert (other != big).float().mean() > 0.4


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.8])
def test_keep_fraction_is_within_binomial_bounds(rate):
    mask = ght.dropout_keep_mask(torch.arange(16, dtype=torch.int32), 16, 16,
                                 200, rate)
    n = mask.numel()
    p = 1.0 - rate
    sigma = (p * (1 - p) / n) ** 0.5
    frac = mask.float().mean().item()
    assert abs(frac - p) <= 5 * sigma, (frac, p, sigma)
    # and per hidden unit, per image: no unit or image is biased
    per_k = mask.float().mean(dim=(0, 1, 2))
    assert (per_k - p).abs().max().item() <= 5 * (p * (1 - p) / 4096) ** 0.5


def _batch(I=3, C=4, L=9, M=6, vocab=50, seed=0):
    rng = np.random.default_rng(seed)
    tok_len = rng.integers(3, L + 1, size=(I, C))
    tokens = rng.integers(1, vocab, size=(I, C, L))
    m_cap = rng.integers(0, C, size=(I, M))
    caplen = tok_len[np.arange(I)[:, None], m_cap]
    m_first = (rng.random((I, M)) * caplen).astype(np.int64)
    m_last = np.minimum(m_first + 1, caplen - 1)
    iu, ju = np.triu_indices(M, k=1)
    P = len(iu)
    pair_ij = np.broadcast_to(np.stack([iu, ju], 1), (I, P, 2)).copy()
    pair_label = rng.integers(0, 4, size=(I, P))
    pair_valid = rng.random((I, P)) < 0.9
    b = {"tokens": tokens, "tok_len": tok_len, "m_cap": m_cap,
         "m_first": m_first, "m_last": m_last, "pair_ij": pair_ij,
         "pair_label": pair_label, "pair_valid": pair_valid}
    return {k: torch.from_numpy(np.asarray(v, np.int32) if v.dtype != bool
                                else v) for k, v in b.items()}


@pytest.mark.parametrize("rate,train", [(0.0, True), (0.5, True),
                                        (0.5, False)])
def test_fused_and_gather_forms_give_one_loss(rate, train):
    """Training mode (seeds given) at rate 0 and 0.5, and predict mode
    (no seeds: no dropout, the predict grid head under the grid loss)."""
    dims = {"emb_dim": 10, "lstm_hidden": 6, "head_hidden": 24}
    flat = init_relation_params(1, dims)
    table = torch.randn(50, 10, generator=torch.Generator().manual_seed(2))
    batch = _batch()
    seeds = torch.tensor([11, 12, 13], dtype=torch.int32) if train else None
    cw = torch.tensor([0.3, 1.0, 1.0, 1.0])
    losses, grads = {}, {}
    for name, fused, grid_loss in [("gather", False, False),
                                   ("fused pair", True, False),
                                   ("fused grid", True, True),
                                   ("plain grid", False, True)]:
        model = RelationModel(10, 6, 24, fused=fused, dropout=rate)
        model.load_flat(flat)
        loss, _ = steps.relation_loss(model, table, batch, seeds, cw,
                                      grid_loss)
        loss.backward()
        losses[name] = loss.detach()
        grads[name] = {k: p.grad for k, p in model.named_parameters()}
    for name in losses:
        _close(losses[name], losses["gather"], name)
        for k, g in grads[name].items():
            _close(g, grads["gather"][k], f"{name} {k}")
    # the mask matters: a different seed moves the loss
    if rate and train:
        model = RelationModel(10, 6, 24, fused=True, dropout=rate)
        model.load_flat(flat)
        other, _ = steps.relation_loss(model, table, batch, seeds + 1, cw,
                                       True)
        assert abs(other.item() - losses["gather"].item()) > 1e-4


def _head(G=3, A=5, B=7, K=16, O=4, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = [torch.randn(s, generator=gen, dtype=torch.float64) for s in
              ((G, A, K), (G, B, K), (K,), (K, O), (O,))]
    seeds = torch.randint(0, 2 ** 31 - 1, (G,), generator=gen,
                          dtype=torch.int32)
    labels = torch.randint(0, O, (G, A, B), generator=gen, dtype=torch.int32)
    weights = ((torch.rand(G, A, B, generator=gen) > 0.3)
               * torch.rand(G, A, B, generator=gen)).double()
    return params, seeds, labels, weights


@pytest.mark.parametrize("rate", [0.0, 0.5])
def test_custom_backward_matches_autograd(rate):
    """float64, so the comparison sees the formulas and not rounding."""
    params, seeds, labels, weights = _head()
    params = [p.requires_grad_() for p in params]
    sums = ght.grid_head_train_loss(*params, seeds, labels, weights, rate)
    want = ght.grid_head_train_loss_reference(*params, seeds, labels,
                                              weights, rate)
    for a, b in zip(sums, want):
        assert torch.equal(a.detach(), b.detach())
    got_g = torch.autograd.grad(sums[0] * 0.7, params)
    want_g = torch.autograd.grad(want[0] * 0.7, params)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)

    R = torch.randn(3, 5, 7, 4, dtype=torch.float64)
    out = ght.grid_head_train(*params, seeds, rate)
    ref = ght.grid_head_train_reference(*params, seeds, rate)
    assert torch.equal(out.detach(), ref.detach())
    got_g = torch.autograd.grad((out * R).sum(), params)
    want_g = torch.autograd.grad((ref * R).sum(), params)
    for a, b in zip(got_g, want_g):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("G,A,B,K,O", [(1, 5, 7, 30, 1), (2, 7, 9, 50, 2),
                                       (2, 9, 17, 30, 3), (1, 17, 20, 50, 4),
                                       (2, 20, 33, 30, 8)])
def test_custom_backward_matches_autograd_at_tile_edges(G, A, B, K, O):
    """Dropout 0.5 at shapes that stress the forward kernels' tiling: ragged
    A and B, K no multiple of 4, every head width (float64)."""
    params, seeds, labels, weights = _head(G, A, B, K, O, seed=5)
    params = [p.requires_grad_() for p in params]
    sums = ght.grid_head_train_loss(*params, seeds, labels, weights, 0.5)
    want = ght.grid_head_train_loss_reference(*params, seeds, labels,
                                              weights, 0.5)
    for a, b in zip(sums, want):
        assert torch.equal(a.detach(), b.detach())
    for a, b in zip(torch.autograd.grad(sums[0] * 0.7, params),
                    torch.autograd.grad(want[0] * 0.7, params)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    R = torch.randn(G, A, B, O, dtype=torch.float64)
    out = ght.grid_head_train(*params, seeds, 0.5)
    ref = ght.grid_head_train_reference(*params, seeds, 0.5)
    assert torch.equal(out.detach(), ref.detach())
    for a, b in zip(torch.autograd.grad((out * R).sum(), params),
                    torch.autograd.grad((ref * R).sum(), params)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("density", [0.0, 0.19, 1.0])
def test_loss_backward_at_weight_densities(density):
    """Dropout 0.5; the share of cells of weight > 0 from none to all: the
    explicit backward equals autograd, and with no weighted cell every sum
    and gradient is exactly zero."""
    params, seeds, labels, _ = _head(4, 16, 16, 24, 4, seed=7)
    gen = torch.Generator().manual_seed(8)
    weights = ((torch.rand(4, 16, 16, generator=gen) < density)
               * (0.3 + torch.rand(4, 16, 16, generator=gen))).double()
    assert abs((weights > 0).double().mean().item() - density) < 0.05
    params = [p.requires_grad_() for p in params]
    sums = ght.grid_head_train_loss(*params, seeds, labels, weights, 0.5)
    want = ght.grid_head_train_loss_reference(*params, seeds, labels,
                                              weights, 0.5)
    got_g = torch.autograd.grad(sums[0] * 1.3, params)
    want_g = torch.autograd.grad(want[0] * 1.3, params)
    for a, b in zip((*sums, *got_g), (*want, *want_g)):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-12,
                                   atol=1e-12)
        if density == 0.0:
            assert not a.any()


def test_zero_weight_cells_are_inert():
    params, seeds, labels, weights = _head(seed=3)
    params = [p.requires_grad_() for p in params]
    poisoned = torch.where(weights > 0, labels, 3)
    a = ght.grid_head_train_loss(*params, seeds, labels, weights, 0.5)
    b = ght.grid_head_train_loss(*params, seeds, poisoned, weights, 0.5)
    for x, y in zip(a, b):
        assert torch.equal(x.detach(), y.detach())
    ga = torch.autograd.grad(a[0], params)
    gb = torch.autograd.grad(b[0], params)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y)


def test_recurrence_backward_matches_autograd():
    """The recurrence's residual-set backward vs autograd through the
    plain loop (float64), with ragged lengths and a length-0 row."""
    gen = torch.Generator().manual_seed(5)
    G, L, B, H = 2, 7, 4, 5
    x = torch.randn(G, L, B, 4 * H, generator=gen,
                    dtype=torch.float64).requires_grad_()
    R = torch.randn(G, H, 4 * H, generator=gen,
                    dtype=torch.float64).requires_grad_()
    lengths = torch.tensor([7, 0, 3, 6])
    t = torch.arange(L)[:, None]
    mask = torch.stack([t < lengths, (L - 1 - t) < lengths]).contiguous()
    w_hs = torch.randn(G, L, B, H, generator=gen, dtype=torch.float64)
    w_fin = torch.randn(G, B, H, generator=gen, dtype=torch.float64)
    grads = []
    for fn in (lstm_recurrence, lstm_recurrence_reference):
        hs, fin = fn(x, mask, R)
        grads.append(torch.autograd.grad(
            (hs * w_hs).sum() + (fin * w_fin).sum(), (x, R)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    # the residuals are those of the plain loop
    hs, _, gates, c = lstm_recurrence_reference(x, mask, R, residuals=True)
    assert gates.shape == (G, L, B, 4 * H) and c.shape == (G, L, B, H)
    assert not c[:, :, 1].any() and not hs[:, :, 1].any()
