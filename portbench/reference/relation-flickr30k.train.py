"""Plain reference of the relation model's train step (ImageCaptionLearn_py's
pairwise mention-relation classifier), float32, one image at a time in
meaning.

Per image: each caption through a BiLSTM over its own tokens (200 units a
direction); a mention's representation is [fwd h; bwd h] at its first token
then at its last (4H); a pair (i, j) is scored relu(m_i W1[:4H] + m_j W1[4H:]
+ b1) -> dropout -> W2 + b2 over the 4 classes.  The step: class-weighted
cross-entropy summed over the batch's pairs over the sum of the weights,
per-cell dropout (:func:`plain.keep_mask`, seeded per image), Adam (b1 0.9,
b2 0.999, eps 1e-8, bias-corrected).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import plain


def _encode(p: dict, table: torch.Tensor, images: list[dict]):
    """Mention representations [sum M, 4H] and each image's row offset."""
    dev = table.device
    caps = [c for im in images for c in im["captions"]]
    tokens, lengths = plain.pad_rows(caps, dev)
    x = table[tokens]
    pre = "caption_bilstm/"
    hf, _ = plain.lstm(x, lengths, p[pre + "fwd/kernel"],
                       p[pre + "fwd/recurrent_kernel"], p[pre + "fwd/bias"])
    hr, _ = plain.lstm(plain.reverse_rows(x, lengths), lengths,
                       p[pre + "bwd/kernel"], p[pre + "bwd/recurrent_kernel"],
                       p[pre + "bwd/bias"])
    enc = torch.cat([hf, plain.reverse_rows(hr, lengths)], -1)   # [N, T, 2H]
    rows, first, last, offsets = [], [], [], []
    cap0 = 0
    for im in images:
        offsets.append(len(rows))
        for c, f, l in im["mentions"]:
            rows.append(cap0 + c)
            first.append(f)
            last.append(l)
        cap0 += len(im["captions"])
    rows = torch.tensor(rows, device=dev)
    reps = torch.cat([enc[rows, torch.tensor(first, device=dev)],
                      enc[rows, torch.tensor(last, device=dev)]], -1)
    return reps, offsets


def _pair_logits(p: dict, reps: torch.Tensor, offsets: list[int],
                 images: list[dict], seeds=None, rate: float = 0.0):
    """Logits [sum P, O] of every image's pairs, in order."""
    dev = reps.device
    W1, b1 = p["head_dense/kernel"], p["head_dense/bias"]
    W2, b2 = p["head_out/kernel"], p["head_out/bias"]
    R = reps.shape[1]
    X, Y = reps @ W1[:R], reps @ W1[R:]
    out = []
    for n, (im, off) in enumerate(zip(images, offsets)):
        pij = torch.as_tensor(np.asarray(im["pairs"]), device=dev).long()
        h = torch.relu(X[off + pij[:, 0]] + Y[off + pij[:, 1]] + b1)
        if seeds is not None and rate > 0:
            keep = plain.keep_mask(int(seeds[n]), pij[:, 0], pij[:, 1],
                                   h.shape[1], rate)
            scale = float(np.float32(1.0 / (1.0 - rate)))
            h = h * torch.where(keep, scale, 0.0)
        out.append(h @ W2 + b2)
    return torch.cat(out)


def loss(p: dict, table: torch.Tensor, images: list[dict], seeds,
         class_weights, rate: float) -> torch.Tensor:
    """The step's loss: sum ce * w over the pairs / max(sum w, 1)."""
    reps, offsets = _encode(p, table, images)
    logits = _pair_logits(p, reps, offsets, images, seeds, rate)
    labels = torch.as_tensor(np.concatenate(
        [im["labels"] for im in images]), device=logits.device).long()
    w = torch.as_tensor(class_weights, dtype=torch.float32,
                        device=logits.device)[labels]
    ce = torch.logsumexp(logits, -1) - logits.gather(1, labels[:, None])[:, 0]
    return (ce * w).sum() / torch.clamp_min(w.sum(), 1.0)


def train(p0: dict, table: torch.Tensor, steps: list, class_weights,
          rate: float, lr: float) -> dict:
    """Adam steps from ``p0`` over ``steps`` = [(images, seeds)]: the loss
    of each step, the first step's gradient and the parameters after the
    last step."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    with plain.exact_f32():
        for t, (images, seeds) in enumerate(steps, start=1):
            L = loss(p, table, images, seeds, class_weights, rate)
            grads = torch.autograd.grad(L, list(p.values()))
            losses.append(float(L.detach()))
            with torch.no_grad():
                for (k, w), g in zip(p.items(), grads):
                    m[k].mul_(0.9).add_(g, alpha=0.1)
                    v2[k].mul_(0.999).addcmul_(g, g, value=0.001)
                    mhat = m[k] / (1 - 0.9 ** t)
                    vhat = v2[k] / (1 - 0.999 ** t)
                    w.sub_(lr * mhat / (vhat.sqrt() + 1e-8))
            if t == 1:
                first_grad = {k: g.detach() for k, g in zip(p, grads)}
    return {"losses": losses, "grad": first_grad,
            "params": {k: w.detach() for k, w in p.items()}}
