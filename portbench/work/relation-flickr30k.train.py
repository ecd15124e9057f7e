"""Work of the relation model's train step, counted from a batch's shapes
and validity.

``stats`` reads a batch's host arrays; ``flops`` is the step's useful float
work (valid tokens, mentions and pairs only): the forward, and the
backward: the caption projection and recurrence twice more (dX or dh,
and the weight's gradient), the mention projections twice more, the grid
head's backward (dz, dX, dY, dW2) with its dropout; the frozen word vectors
get no gradient.  ``ght_loss_bwd_bound_s`` is the least time the card could
take for the fused-loss backward (K8) of a train step: the kernel table's
arithmetic for ``loss_bwd`` over the cells of weight > 0, its float
operations at the f32 rate (in the one-pass mode, ``exact`` False, its
products of bf16 values at the bf16 rate), its hash at the integer rate
and its bytes at HBM rate (inputs read once, outputs written once).
"""

from __future__ import annotations

import numpy as np

from portbench.lib import peaks

HASH_INT_OPS = 10     # integer operations of the dropout hash, per element


def stats(arrays: dict, cfg: dict) -> dict:
    tok_len = np.asarray(arrays["tok_len"])
    I, C, L = np.shape(arrays["tokens"])
    return {"I": int(I), "C": int(C), "L": int(L),
            "M": int(np.shape(arrays["m_cap"])[1]),
            "tokens": int(tok_len.sum()),
            "mentions": int(np.asarray(arrays["m_valid"]).sum()),
            "pairs": int(np.asarray(arrays["pair_valid"]).sum())}


def _parts(s: dict, cfg: dict) -> dict:
    D, H, K = cfg["emb_dim"], cfg["lstm_hidden"], cfg["head_hidden"]
    O = cfg["num_classes"]
    return {"proj": 2 * s["tokens"] * 2 * D * 4 * H,
            "rec": 2 * s["tokens"] * (8 * H * H + 10 * H),
            "ment": s["mentions"] * 2 * 2 * 4 * H * K,
            "head": s["mentions"] * K + s["pairs"] * K * (2 + 2 * O),
            "soft": s["pairs"] * 6 * O}


def flops(s: dict, cfg: dict, rate: float = 0.5) -> float:
    p = _parts(s, cfg)
    K, O = cfg["head_hidden"], cfg["num_classes"]
    drop = 1 if rate > 0 else 0
    head_bwd = s["pairs"] * K * (6 + 4 * O + 2 * drop) + s["pairs"] * 8 * O
    return float(p["proj"] * 2 + p["rec"] * 3 + p["ment"] * 3
                 + p["head"] + s["pairs"] * K * drop + p["soft"] + head_bwd)


def ght_loss_bwd_bound_s(s: dict, cfg: dict, rate: float = 0.5,
                         exact: bool = True) -> float:
    G, A, K, O = s["I"], s["M"], cfg["head_hidden"], cfg["num_classes"]
    cells = s["pairs"]
    drop = 1 if rate > 0 else 0
    pre = G * A * K
    fwd = cells * K * (2 + 2 * O + drop)
    bwd = cells * K * (6 + 4 * O + 2 * drop)
    f_ops = 2 * pre + fwd + bwd + cells * 8 * O
    i_ops = cells * K * HASH_INT_OPS if drop else 0
    n = cells * K
    b_ops = 0 if exact else n * 6 * O  # one pass: products of bf16 values
    if not exact:
        f_ops = f_ops - b_ops + n + n  # their roundings, two an element
    nbytes = 4 * (2 * (G * A * K) * 2          # X, Y in; dX, dY out
                  + K + K * O + O              # b1, W2, b2 in
                  + G + 2 * G * A * A + 1      # seeds, labels, weights, gl
                  + K * O + K + O)             # dW2, db1, db2 out
    return max(f_ops / peaks.F32, i_ops / peaks.INT32, b_ops / peaks.BF16,
               nbytes / peaks.HBM)
