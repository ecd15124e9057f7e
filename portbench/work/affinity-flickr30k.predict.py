"""Work of the affinity model, counted from a batch's shapes and validity.

``stats`` reads a batch's host arrays (as the batcher padded them);
``flops`` is the model's useful float work on them (valid tokens, phrases,
boxes and cells only); ``lstm_bound_s`` is the least time the card could
take for the phrase LSTM's recurrence call (the arithmetic of the kernel
table's ``bound``: the call's bytes, each input read once and each output
written once, at HBM rate; its gate operations at the f32 rate; h.R as three
TF32 passes, the least an f32-grade product can take on the tensor cores).
"""

from __future__ import annotations

import numpy as np

from portbench.lib import peaks


def stats(arrays: dict, cfg: dict) -> dict:
    plen = np.asarray(arrays["phrase_len"])
    I, M, L = np.shape(arrays["phrase_tokens"])
    box_valid = np.asarray(arrays["box_valid"])
    phrases = (plen > 0).sum(1)
    boxes = box_valid.sum(1)
    return {"I": int(I), "M": int(M), "L": int(L),
            "B": int(box_valid.shape[1]),
            "tokens": int(plen.sum()), "phrases": int(phrases.sum()),
            "boxes": int(boxes.sum()),
            "cells": int((phrases * boxes).sum())}


def flops(s: dict, cfg: dict) -> float:
    D, H, K = cfg["emb_dim"], cfg["lstm_hidden"], cfg["head_hidden"]
    O, Dbox = cfg["num_classes"], cfg["box_dim"]
    return float(s["tokens"] * 2 * D * 4 * H            # input projection
                 + s["tokens"] * (8 * H * H + 10 * H)    # recurrence
                 + s["phrases"] * 2 * H * K              # phrase projection
                 + s["boxes"] * 2 * Dbox * K             # box projection
                 + s["phrases"] * K                      # + b1
                 + s["cells"] * K * (2 + 2 * O)          # grid head
                 + s["cells"] * 2 * K                    # ranking's column
                 + s["cells"] * (6 * O + 6))             # the two softmaxes


def lstm_bound_s(s: dict, cfg: dict) -> float:
    H = cfg["lstm_hidden"]
    rows = s["I"] * s["M"]
    nbytes = (s["L"] * rows * 4 * H * 4       # x_proj in
              + s["L"] * rows                 # mask
              + H * 4 * H * 4                 # R
              + s["L"] * rows * H * 4         # h out
              + rows * H * 4)                 # final h out
    return max(s["tokens"] * 10 * H / peaks.F32,
               3 * s["tokens"] * 8 * H * H / peaks.TF32,
               nbytes / peaks.HBM)
