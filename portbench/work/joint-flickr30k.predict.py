"""Work of joint inference, counted from each batch's shapes and validity.

``stats(task, arrays, n, cfg)`` reads a batch's host arrays as its batcher
padded them (``n``: the examples it holds); ``flops`` is the useful float
work of that batch's predict (valid tokens, mentions, pairs, phrases,
boxes, cells and mention rows only):

* relation: the BiLSTM's input projection and recurrence in both
  directions, each mention's two head projections (m W1[:4H], m W1[4H:]),
  b1, the grid head over the valid pairs and their softmax;
* affinity with the ranking: ``affinity-flickr30k.predict.py``'s count at
  this configuration's widths;
* nonvisual, cardinality: the mean of the mention's word vectors, the two
  dense layers and the softmax.

``grid_head_bound_s`` is the least time the card could take for the
relation predict's grid head call (K1, ``csrc/grid_head.cu``) on one
batch: the kernel table's arithmetic, its grid of G = I images by A = B = M
mentions (the kernel scores every cell of it): X + b1 and, per cell of
[G, A, B, K], the add, the ReLU and the O-wide dot, at the f32 rate; its
bytes (X, Y, b1, W2, b2 read once, the [G, A, B, O] logits written once)
at HBM rate.
"""

from __future__ import annotations

import os

import numpy as np

from portbench.lib import cell, peaks

_AFFINITY = cell.load_module(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "affinity-flickr30k.predict.py"))


def _affinity_cfg(cfg: dict) -> dict:
    return {"emb_dim": cfg["emb_dim"], "lstm_hidden": cfg["lstm_hidden"],
            "head_hidden": cfg["affinity_head_hidden"],
            "num_classes": cfg["affinity_classes"], "box_dim": cfg["box_dim"]}


def stats(task: str, arrays: dict, n: int, cfg: dict) -> dict:
    if task == "affinity":
        return {"task": task, **_AFFINITY.stats(arrays, _affinity_cfg(cfg))}
    if task == "relation":
        I, _, _ = np.shape(arrays["tokens"])
        return {"task": task, "I": int(I),
                "M": int(np.shape(arrays["m_cap"])[1]),
                "tokens": int(np.asarray(arrays["tok_len"]).sum()),
                "mentions": int(np.asarray(arrays["m_valid"]).sum()),
                "pairs": int(np.asarray(arrays["pair_valid"]).sum())}
    return {"task": task, "rows": int(n),
            "tokens": int(np.asarray(arrays["lengths"])[:n].sum())}


def flops(s: dict, cfg: dict) -> float:
    task, D, H = s["task"], cfg["emb_dim"], cfg["lstm_hidden"]
    if task == "affinity":
        return _AFFINITY.flops(s, _affinity_cfg(cfg))
    if task == "relation":
        K, O = cfg["relation_head_hidden"], cfg["relation_classes"]
        return float(2 * s["tokens"] * 2 * D * 4 * H          # projection
                     + 2 * s["tokens"] * (8 * H * H + 10 * H)  # recurrence
                     + s["mentions"] * 2 * 2 * 4 * H * K      # X and Y
                     + s["mentions"] * K                      # + b1
                     + s["pairs"] * K * (2 + 2 * O)           # grid head
                     + s["pairs"] * 6 * O)                    # softmax
    Hm, C = cfg["mention_hidden"], cfg[f"{task}_classes"]
    return float((s["tokens"] + s["rows"]) * D                # mean
                 + s["rows"] * (2 * D * Hm + 2 * Hm + 2 * Hm * C + C)
                 + s["rows"] * 6 * C)                         # softmax


def grid_head_bound_s(s: dict, cfg: dict) -> float:
    G, A, B = s["I"], s["M"], s["M"]
    K, O = cfg["relation_head_hidden"], cfg["relation_classes"]
    ops = G * A * K + G * A * B * K * (2 + 2 * O)
    nbytes = 4 * (G * A * K + G * B * K + K + K * O + O + G * A * B * O)
    return max(ops / peaks.F32, nbytes / peaks.HBM)
