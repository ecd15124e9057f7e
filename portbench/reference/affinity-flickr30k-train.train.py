"""Plain reference of the affinity model's train step (ImageCaptionLearn_py's
phrase-box affinity scorer, trained with the grid loss), float32, one image
at a time in meaning.

Per image: each phrase through an LSTM over its own tokens (200 units), its
final state h; X = h Wp + bp (the phrases) and Y = f Wb (the 4096-d box
features f); a (phrase a, box b) cell is scored relu(X_a + Y_b) -> dropout
-> W2 + b2 over the 2 classes.  The step: cross-entropy summed over every
candidate cell of the batch over the count of those cells (no class
weights), per-cell dropout (:func:`plain.keep_mask`, seeded per image, cell
(a, b) = (phrase row, box column)), Adam (b1 0.9, b2 0.999, eps 1e-8,
bias-corrected).  The box features are an input: they get no gradient, and
neither do the word vectors.

Departures from the published model: it reads ``[phrase embedding; box
features]`` into one Dense layer; that product is written here as its two
halves, Wp and Wb, whose sum it is.  Its dropout draws Keras's mask; here
the mask is the configuration's hash of (seed, a, b, unit), the one the
program draws.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import plain


def loss(p: dict, table: torch.Tensor, boxes, images: list[dict], seeds,
         rate: float) -> torch.Tensor:
    """The step's loss: sum of every candidate cell's ce / max(cells, 1);
    an image is a dict with ``phrases``, ``box_row``, ``n_boxes`` and
    ``labels`` (int [M, n_boxes])."""
    dev = table.device
    phrases = [ph for im in images for ph in im["phrases"]]
    tokens, lengths = plain.pad_rows(phrases, dev)
    _, h = plain.lstm(table[tokens], lengths, p["phrase_lstm/kernel"],
                      p["phrase_lstm/recurrent_kernel"], p["phrase_lstm/bias"])
    X = h @ p["head_dense_phrase/kernel"] + p["head_dense_phrase/bias"]
    W2, b2 = p["head_out/kernel"], p["head_out/bias"]
    total, cells, row = X.new_zeros(()), 0, 0
    scale = float(np.float32(1.0 / (1.0 - rate))) if rate > 0 else 1.0
    for n, im in enumerate(images):
        M, nb = len(im["phrases"]), im["n_boxes"]
        f = torch.as_tensor(boxes[im["box_row"]:im["box_row"] + nb],
                            device=dev)
        Y = f @ p["head_dense_box/kernel"]
        hid = torch.relu(X[row:row + M, None] + Y[None])      # [M, nb, K]
        if rate > 0:
            a, b = torch.meshgrid(torch.arange(M, device=dev),
                                  torch.arange(nb, device=dev),
                                  indexing="ij")
            keep = plain.keep_mask(int(seeds[n]), a.reshape(-1),
                                   b.reshape(-1), hid.shape[-1], rate)
            hid = hid * torch.where(keep, scale, 0.0).reshape(hid.shape)
        logits = (hid @ W2 + b2).reshape(M * nb, -1)
        labels = torch.as_tensor(np.asarray(im["labels"]).reshape(-1),
                                 device=dev).long()
        ce = (torch.logsumexp(logits, -1)
              - logits.gather(1, labels[:, None])[:, 0])
        total = total + ce.sum()
        cells += M * nb
        row += M
    return total / max(cells, 1)


def train(p0: dict, table: torch.Tensor, boxes, steps: list, rate: float,
          lr: float) -> dict:
    """Adam steps from ``p0`` over ``steps`` = [(images, seeds)], the box
    features the split's block (host float32 [rows, 4096]): the loss of
    each step, the first step's gradient and the parameters after the last
    step."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad = [], None
    with plain.exact_f32():
        for t, (images, seeds) in enumerate(steps, start=1):
            L = loss(p, table, boxes, images, seeds, rate)
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
