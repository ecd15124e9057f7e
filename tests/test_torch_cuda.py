"""Hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without an NVIDIA GPU.  The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

f32, TF32 off.  Gate: max |kernel - plain| <= 1e-5 * max(1, max |plain|);
the kernels sum in another order than cuBLAS and the eager ops.
"""

import pytest
import torch

from icl_torch.models.relation import RelationModel
from icl_torch.ops.grid_head import grid_head, grid_head_reference
from icl_torch.ops.lstm_recurrence import (lstm_recurrence,
                                           lstm_recurrence_reference)
from icl_torch.params import init_relation_params
from icl_torch.train.steps import relation_predict

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
    (3, 9, 130, 16, 2), (2, 5, 7, 33, 3), (2, 4, 4, 1024, 2)])
def test_grid_head_kernel_matches_plain(dev, G, A, B, K, O):
    args = _head_inputs(G, A, B, K, O, dev)
    n0 = grid_head.launches
    out = grid_head(*args)
    torch.cuda.synchronize()
    assert grid_head.launches == n0 + 1
    _assert_close(out, grid_head_reference(*args))
    assert torch.equal(out, grid_head(*args))       # bitwise repeatable


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
    lengths[0] = 0
    lengths[-1] = L
    t = torch.arange(L, device=dev)[:, None]
    mask = torch.stack([t < lengths, (L - 1 - t) < lengths])[:G]
    return x_proj, mask.contiguous(), R


@pytest.mark.parametrize("G,L,B,H", [
    (2, 16, 8, 200), (2, 32, 64, 200), (2, 48, 37, 200), (1, 1, 3, 8),
    (2, 9, 13, 40), (2, 5, 6, 3), (1, 7, 5, 256)])
def test_recurrence_kernel_matches_plain(dev, G, L, B, H):
    args = _rec_inputs(G, L, B, H, dev)
    n0 = lstm_recurrence.launches
    hs, fin = lstm_recurrence(*args)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == n0 + 1
    hs_ref, fin_ref = lstm_recurrence_reference(*args)
    _assert_close(hs, hs_ref)
    _assert_close(fin, fin_ref)
    assert not hs[:, :, 0].any()                    # the length-0 row
    hs2, _ = lstm_recurrence(*args)
    assert torch.equal(hs, hs2)                     # bitwise repeatable


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x_proj, mask, R = _rec_inputs(2, 4, 8, 16, dev)
    with pytest.raises(TypeError):
        lstm_recurrence(x_proj.double(), mask, R.double())
    with pytest.raises(ValueError, match="contiguous"):
        lstm_recurrence(x_proj.transpose(1, 2), mask.transpose(1, 2), R)
    with pytest.raises(ValueError, match="H=257"):
        lstm_recurrence(*_rec_inputs(2, 4, 8, 257, dev))
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
