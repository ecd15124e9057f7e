"""Work of the affinity model's train step, counted from a batch's shapes
and validity.

``stats`` reads a batch's host arrays: the predict entry's counts
(``work/affinity-flickr30k.predict.py``), with ``cells`` the candidate
cells (``grid_valid``), those the loss is taken over.  ``flops`` is the
step's useful float work (valid tokens, phrases, boxes and cells only): the
forward, and the backward: the phrase input projection twice more (its
weight's gradient; the frozen word vectors get none), the recurrence twice
more (the dgates . R^T chain and dR), the phrase projection twice more
(dh and dWp), the box projection once more (dWb; the box features are an
input and get none), and the grid head's backward (dz, dX, dY, dW2) with
its dropout, counted as ``work/relation-flickr30k.train.py`` counts it.

``ght_loss_bwd_bound_s`` is the least time the card could take for the
fused-loss backward (K8) of a step, with the relation train step's
arithmetic over a grid of A phrases by B boxes: its float operations at
the f32 rate (in the one-pass mode, ``exact`` False, its products of bf16
values at the bf16 rate), its hash at the integer rate, its bytes at HBM
rate (inputs read once, outputs written once).  ``lstm_bwd_bound_s`` is the
least time for the recurrence's backward kernel alone
(``lstm_bwd_cluster_kernel``; the dR GEMM after it is a cuBLAS launch of
its own): dgates . R^T, 8 H^2 operations at every valid (row, step) but a
row's first, and about 20 H a valid (row, step) for the gate cotangents,
at the f32 rate; or its bytes at HBM rate (gates, c, mask, R^T, dhs and
the final dh in, dgates out, over the padded [L, I * M] rows it is given).
"""

from __future__ import annotations

import numpy as np

from portbench.lib import cell, peaks

HASH_INT_OPS = 10     # integer operations of the dropout hash, per element

_predict = cell.load_module(cell.part("work", "affinity-flickr30k.predict"))


def stats(arrays: dict, cfg: dict) -> dict:
    return {**_predict.stats(arrays, cfg),
            "cells": int(np.count_nonzero(arrays["grid_valid"]))}


def flops(s: dict, cfg: dict, rate: float = 0.5) -> float:
    D, H, K = cfg["emb_dim"], cfg["lstm_hidden"], cfg["head_hidden"]
    O, Dbox = cfg["num_classes"], cfg["box_dim"]
    drop = 1 if rate > 0 else 0
    cells = s["cells"]
    head = s["phrases"] * K + cells * K * (2 + 2 * O + drop) + cells * 6 * O
    head_bwd = cells * K * (6 + 4 * O + 2 * drop) + cells * 8 * O
    return float(2 * s["tokens"] * 2 * D * 4 * H               # x W, dW
                 + 3 * s["tokens"] * (8 * H * H + 10 * H)      # recurrence
                 + 3 * s["phrases"] * 2 * H * K                # h Wp
                 + 2 * s["boxes"] * 2 * Dbox * K               # f Wb
                 + head + head_bwd)


def ght_loss_bwd_bound_s(s: dict, cfg: dict, rate: float = 0.5,
                         exact: bool = True) -> float:
    G, A, B = s["I"], s["M"], s["B"]
    K, O = cfg["head_hidden"], cfg["num_classes"]
    cells = s["cells"]
    drop = 1 if rate > 0 else 0
    pre = G * (A + B) * K
    fwd = cells * K * (2 + 2 * O + drop)
    bwd = cells * K * (6 + 4 * O + 2 * drop)
    f_ops = pre + fwd + bwd + cells * 8 * O
    i_ops = cells * K * HASH_INT_OPS if drop else 0
    n = cells * K
    b_ops = 0 if exact else n * 6 * O  # one pass: products of bf16 values
    if not exact:
        f_ops = f_ops - b_ops + n + n  # their roundings, two an element
    nbytes = 4 * (2 * G * (A + B) * K          # X, Y in; dX, dY out
                  + K + K * O + O              # b1, W2, b2 in
                  + G + 2 * G * A * B + 1      # seeds, labels, weights, gl
                  + K * O + K + O)             # dW2, db1, db2 out
    return max(f_ops / peaks.F32, i_ops / peaks.INT32, b_ops / peaks.BF16,
               nbytes / peaks.HBM)


def lstm_bwd_bound_s(s: dict, cfg: dict) -> float:
    H = cfg["lstm_hidden"]
    rows, L = s["I"] * s["M"], s["L"]
    ops = (s["tokens"] - s["phrases"]) * 8 * H * H + s["tokens"] * 20 * H
    nbytes = (4 * (2 * L * rows * 4 * H        # gates in, dgates out
                   + 2 * L * rows * H          # c, dhs in
                   + 4 * H * H                 # R^T in
                   + rows * H)                 # final dh in
              + L * rows)                      # mask in
    return max(ops / peaks.F32, nbytes / peaks.HBM)
