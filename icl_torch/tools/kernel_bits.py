"""Every kernel entry point's output at chip_smoke.py's phase 3 shapes,
saved for a bitwise comparison between two trees of the repository.

A GPU tool.  One process imports one tree's ``icl_torch`` (the one first
on ``PYTHONPATH``), feeds each entry point seeded inputs and saves the
outputs: the f32 modes (K1/K2, the recurrence with and without its
residuals, K5-K8 at rate 0 and 0.5, K9), the bf16 modes (the fast dot of
K1/K2 and K9, the bf16 recurrence) and, where the tree has it, the
one-pass bf16 mode of K5-K8 (``exact=False``), on the same inputs: a tree
without a mode draws the same random numbers for the others.
``--compare`` loads two such files and says, case by case, whether the
bits are equal; it fails on a case of the first file that the second
lacks or computes otherwise, and lists the second's new cases.  On one
card, from the repository's root, with the other tree unpacked under
``_archive/parent``::

    PYTHONPATH=_archive/parent python icl_torch/tools/kernel_bits.py p.pt
    PYTHONPATH=. python icl_torch/tools/kernel_bits.py c.pt
    python icl_torch/tools/kernel_bits.py --compare p.pt c.pt

The script's own directory is first on ``sys.path``, so ``icl_torch``
comes from ``PYTHONPATH``: run the script file by its path, not with
``-m``.
"""

from __future__ import annotations

import sys

import torch


def outputs(seed: int = 0) -> dict:
    """{case: tuple of output tensors} of every entry point."""
    from icl_torch.ops import grid_head_train as ght
    from icl_torch.ops.affinity_rank import affinity_rank
    from icl_torch.ops.grid_head import grid_head
    from icl_torch.ops.lstm_recurrence import lstm_recurrence_fwd

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def head(G, A, B, K, O):
        return (rnd(G, A, K), rnd(G, B, K), rnd(K), rnd(K, O) / K ** 0.5,
                rnd(O))

    onepass = hasattr(ght.grid_head_train_fwd, "onepass")
    out = {}
    for G, A, B, K, O in ((1, 16, 16, 800, 4), (8, 16, 16, 800, 4),
                          (64, 16, 16, 800, 4), (64, 16, 32, 1024, 2),
                          (2, 9, 17, 800, 3), (2, 20, 33, 50, 8),
                          (1, 5, 7, 30, 1)):
        args = head(G, A, B, K, O)
        out[f"grid_head {G} {A} {B} {K} {O}"] = (grid_head(*args),)
        out[f"grid_head bf16dot {G} {A} {B} {K} {O}"] = (
            grid_head(*args, fast_dot=True),)
        seeds = torch.randint(0, 2 ** 31 - 1, (G,), generator=gen,
                              device=dev, dtype=torch.int32)
        labels = torch.randint(0, O, (G, A, B), generator=gen, device=dev,
                               dtype=torch.int32)
        weights = (rnd(G, A, B) > 0).float()
        cot = rnd(G, A, B, O)
        X, Y, b1, W2, b2 = args
        for rate in (0.0, 0.5):
            tag = f"{G} {A} {B} {K} {O} rate {rate}"
            out[f"K5 {tag}"] = (ght.grid_head_train_fwd(*args, seeds, rate),)
            out[f"K6 {tag}"] = ght.grid_head_train_bwd(X, Y, b1, W2, seeds,
                                                       cot, rate)
            out[f"K7 {tag}"] = ght.grid_head_train_loss_fwd(
                *args, seeds, labels, weights, rate)
            out[f"K8 {tag}"] = ght.grid_head_train_loss_bwd(
                *args, seeds, labels, weights, torch.ones((), device=dev),
                rate)
            if onepass:
                out[f"K5 onepass {tag}"] = (ght.grid_head_train_fwd(
                    *args, seeds, rate, False),)
                out[f"K6 onepass {tag}"] = ght.grid_head_train_bwd(
                    X, Y, b1, W2, seeds, cot, rate, False)
                out[f"K7 onepass {tag}"] = ght.grid_head_train_loss_fwd(
                    *args, seeds, labels, weights, rate, False)
                out[f"K8 onepass {tag}"] = ght.grid_head_train_loss_bwd(
                    *args, seeds, labels, weights,
                    torch.ones((), device=dev), rate, False)
    for G, L, B, H in ((2, 32, 64, 200), (2, 32, 512, 200),
                       (1, 16, 1024, 200), (2, 16, 61, 256), (2, 8, 5, 64)):
        lengths = torch.randint(0, L + 1, (B,), generator=gen, device=dev)
        t = torch.arange(L, device=dev)[:, None]
        mask = torch.stack([t < lengths, (L - 1 - t) < lengths])[:G]
        args = (rnd(G, L, B, 4 * H), mask.contiguous(),
                rnd(G, H, 4 * H) / H ** 0.5)
        out[f"recurrence {G} {L} {B} {H}"] = lstm_recurrence_fwd(*args)
        out[f"recurrence {G} {L} {B} {H} residuals"] = lstm_recurrence_fwd(
            *args, residuals=True)
        bf16 = (args[0].bfloat16(), args[1], args[2].bfloat16())
        out[f"recurrence bf16 {G} {L} {B} {H} residuals"] = \
            lstm_recurrence_fwd(*bf16, residuals=True)
    for G in (4, 64):
        valid = rnd(G, 32) > -0.5
        valid[:, 0] = True
        args = head(G, 16, 32, 1024, 2)
        out[f"affinity_rank {G}"] = (affinity_rank(*args, valid),)
        out[f"affinity_rank bf16dot {G}"] = (affinity_rank(
            *args, valid, fast_dot=True),)
    torch.cuda.synchronize()
    return {k: tuple(t.cpu() for t in v) for k, v in out.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--compare"]:
        a, b = (torch.load(p, weights_only=True) for p in argv[1:3])
        differ = [k for k in a if k not in b or len(a[k]) != len(b[k])
                  or not all(torch.equal(x, y) for x, y in zip(a[k], b[k]))]
        new = [k for k in b if k not in a]
        print(f"kernel bits: {len(a) - len(differ)} of {len(a)} cases "
              f"bit-equal; differ: {differ}; {len(new)} cases only in the "
              f"second file: {new}")
        return 1 if differ else 0
    torch.save(outputs(), argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
