"""The backward kernel's walk skips the cells without a cotangent: the premise.

``head_bwd_kernel`` (``icl_torch/csrc/grid_head_train.cu``, K6 and the
second half of K8) walks only the cells whose cotangent g3 has a non-zero
entry.  A skipped cell would add dz = +0 to dX and dY and h * (+0) to dW2;
every sum starts at +0 and is never -0, so the skip leaves each as it was.
That holds for finite X, Y, b1 and W2, as here: an Inf h or an Inf or NaN
W2 entry makes a skipped cell's h * 0 or 0 * W2 a NaN that the walk leaves
out.
Here :func:`_walk` takes the kernel's sums in the kernel's order (thread
(k, s) over its groups of four rows, b in order, the rows of a group in
order; dW2 in even and odd accumulators; the slices' partials in the order
s = 0..3; images in order), with the products and sums the kernel forms
(fused multiply-adds where it has them), once over every cell and once
over the live cells only: the two give equal bits, in both modes, with and
without dropout, where g3 holds zeros of both signs.  The walk is also
held to the plain backward at the f32 gate, so it is the function the
kernel computes.  On the card, ``tests/test_torch_cuda.py`` holds the
kernel to the plain version at such cotangents, and
``icl_torch/tools/kernel_bits.py`` to its parent's bits.
"""

import numpy as np
import pytest
import torch

from icl_torch.ops import grid_head_train as ght

ROWS, SLICES = 4, 4      # kBwdRows, kBwdSlices


def _fma(a, b, c):
    """a * b + c rounded once to f32 (the product is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _walk(X, Y, b1, W2, seeds, g3, rate, exact, live_only):
    """dX, dY, dW2, db1 of the backward kernel, in its order; with
    ``live_only`` the cells whose g3 is zero are not visited."""
    G, A, K = X.shape
    B, O = Y.shape[1], W2.shape[1]

    def rnd(t):      # an operand of a head contraction (bf16 one-pass)
        return ght._operand(t, exact)

    gs, w2 = rnd(g3), rnd(W2)
    if ght.dropout_applies(rate):
        f_all = torch.where(ght.dropout_keep_mask(seeds, A, B, K, rate),
                            ght.dropout_scale(rate), 0.0)
    else:
        f_all = torch.ones(G, A, B, K)
    dX = torch.zeros(G, A, K)
    red = torch.zeros(SLICES, G, B, K)
    dw2 = torch.zeros(SLICES, 2, G, K, O)
    db1 = torch.zeros(SLICES, G, K)
    for s in range(SLICES):
        for a0 in range(s * ROWS, A, SLICES * ROWS):
            rows = range(a0, min(a0 + ROWS, A))
            xk = {a: X[:, a] + b1 for a in rows}
            dx = {a: torch.zeros(G, K) for a in rows}
            for b in range(B):
                dy = torch.zeros(G, K)
                for i, a in enumerate(rows):
                    g = gs[:, a, b]                               # [G, O]
                    walk = ((g != 0).any(-1) if live_only
                            else torch.ones(G, dtype=torch.bool))[:, None]
                    z = xk[a] + Y[:, b]
                    f = f_all[:, a, b]
                    h = rnd(torch.relu(z) * f)
                    sg = torch.where(z > 0, f, 0.0)
                    dh = torch.zeros(G, K)
                    for o in range(O):
                        dh = _fma(g[:, o, None], w2[:, o], dh)
                        acc = dw2[s, i & 1, :, :, o]
                        dw2[s, i & 1, :, :, o] = torch.where(
                            walk, _fma(h, g[:, o, None], acc), acc)
                    dz = dh * sg
                    dx[a] = torch.where(walk, dx[a] + dz, dx[a])
                    dy = torch.where(walk, dy + dz, dy)
                red[s, :, b] = red[s, :, b] + dy
            for a in rows:
                dX[:, a] = dx[a]
                db1[s] = db1[s] + dx[a]
    dY = torch.zeros(G, B, K)
    part_w = torch.zeros(G, K, O)
    part_b = torch.zeros(G, K)
    for s in range(SLICES):
        dY = dY + red[s]
        part_w = part_w + (dw2[s, 0] + dw2[s, 1])
        part_b = part_b + db1[s]
    dW2, dB1 = torch.zeros(K, O), torch.zeros(K)
    for g in range(G):                         # the images, in order
        dW2, dB1 = dW2 + part_w[g], dB1 + part_b[g]
    return dX, dY, dW2, dB1


def _problem(O, seed):
    rng = np.random.default_rng(seed)
    G, A, B, K = 2, 5, 7, 48

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    X, Y, b1 = t(G, A, K), t(G, B, K), t(K)
    W2, b2 = t(K, O, scale=K ** -0.5), t(O)
    seeds = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, G).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, O, (G, A, B)).astype(np.int32))
    weights = torch.from_numpy(
        ((rng.random((G, A, B)) < 0.4)
         * np.where(rng.random((G, A, B)) > 0.5, 1.0, 0.3)).astype(np.float32))
    cot = t(G, A, B, O) * torch.from_numpy(
        rng.random((G, A, B, 1)) < 0.5).float()
    return X, Y, b1, W2, b2, seeds, labels, weights, cot


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("O", [2, 4])
@pytest.mark.parametrize("kernel", ["K6", "K8"])
def test_walking_only_the_live_cells_keeps_the_bits(kernel, O, rate, exact):
    X, Y, b1, W2, b2, seeds, labels, weights, cot = _problem(O, 3 + O)
    if kernel == "K8":     # g3 of the weighted CE: 0 or -0 at weight 0
        g3 = ght.grid_head_train_dlogits_plain(
            X, Y, b1, W2, b2, seeds, labels, weights, torch.tensor(0.37),
            rate, exact)
    else:                  # a cotangent zero on a seeded set of cells
        g3 = cot
    dead = ~(g3 != 0).any(-1)
    assert dead.any() and (~dead).any()
    if kernel == "K8":     # the walk skips exactly the cells of weight 0
        assert torch.equal(dead, weights == 0)
    assert torch.signbit(g3[dead]).any() and not torch.signbit(
        g3[dead]).all()                           # zeros of both signs
    every = _walk(X, Y, b1, W2, seeds, g3, rate, exact, live_only=False)
    live = _walk(X, Y, b1, W2, seeds, g3, rate, exact, live_only=True)
    for a, b in zip(every, live, strict=True):
        assert torch.equal(a, b)
        assert not torch.signbit(a[a == 0]).any()  # no sum ends at -0
    plain = ght.grid_head_train_bwd_plain(X, Y, b1, W2, seeds, g3, rate,
                                          exact)
    for a, b in zip(live, plain, strict=True):
        tol = 1e-5 * max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= tol
