"""Seeded Flickr30k-shaped inputs: the one generator every traffic mix reads.

Shapes (caption lengths, mention and box counts, span lengths) are drawn
once from a fixed stream, so every seed gets the same multiset of sizes;
``--seed`` permutes which image gets which shape and draws the token ids,
labels, box features and weights.  Runs on different seeds then do the same
amount of work.  Pure numpy and torch: nothing of the program is imported.

An image is a plain dict:

* relation: ``img_id``, ``captions`` (list of int32 token-id arrays),
  ``mentions`` (list of ``(caption, first, last)``, row order), ``pairs``
  (int32 [P, 2], every i < j), ``labels`` (int32 [P]);
* affinity: ``img_id``, ``captions``, ``mentions`` (as above; a mention's
  phrase is its span), ``phrases`` (list of int32 arrays), ``box_row``
  (first row of the image's boxes in the split's box block) and
  ``n_boxes``.
"""

from __future__ import annotations

import numpy as np

SHAPE_STREAM = 20151007   # the fixed stream the sizes come from


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *salt]))


def _caption_shapes(cfg: dict, n_images: int, rng: np.random.Generator):
    """Per image: a list of (caption length, [span lengths]) for each
    caption, spans fitting inside the caption."""
    C = cfg["captions_per_image"]
    mean_len = cfg.get("caption_len_mean", 12)
    max_len = cfg.get("caption_len_max", 32)
    per_cap = cfg.get("mentions_per_caption_mean",
                      cfg.get("phrases_per_caption_mean", 3.2))
    p_extra = (cfg.get("mention_len_mean", cfg.get("phrase_len_mean", 2.3))
               - 1.0) / 3.0
    out = []
    for _ in range(n_images):
        caps = []
        for _ in range(C):
            length = int(np.clip(round(rng.gamma(6.0, mean_len / 6.0)), 4,
                                 max_len))
            n = 1 + int(rng.poisson(per_cap - 1.0))
            spans = [1 + int(rng.binomial(3, p_extra)) for _ in range(n)]
            while len(spans) > 1 and sum(spans) > length:
                spans.pop()
            spans[0] = min(spans[0], length)
            caps.append((length, spans))
        out.append(caps)
    return out


def _place(length: int, spans: list[int], rng) -> list[tuple[int, int]]:
    """Non-overlapping (first, last) spans, in order, in a caption."""
    free = length - sum(spans)
    gaps = rng.multinomial(free, np.ones(len(spans) + 1) / (len(spans) + 1))
    out, pos = [], 0
    for g, s in zip(gaps[:-1], spans):
        pos += int(g)
        out.append((pos, pos + s - 1))
        pos += s
    return out


def relation_images(cfg: dict, n_images: int, seed: int) -> list[dict]:
    """``n_images`` relation images: fixed shapes, seed-drawn contents."""
    shapes = _caption_shapes(cfg, n_images, _rng(SHAPE_STREAM, 1))
    rng = _rng(seed, 2)
    order = rng.permutation(n_images)
    V = cfg["vocab_size"]
    prior = np.asarray(cfg["class_prior"], np.float64)
    images = []
    for n, k in enumerate(order):
        captions, mentions = [], []
        for ci, (length, spans) in enumerate(shapes[k]):
            captions.append(rng.integers(1, V + 1, length).astype(np.int32))
            mentions.extend((ci, f, l) for f, l in _place(length, spans, rng))
        M = len(mentions)
        ii, jj = np.triu_indices(M, k=1)
        pairs = np.stack([ii, jj], 1).astype(np.int32)
        labels = rng.choice(len(prior), size=len(pairs),
                            p=prior / prior.sum()).astype(np.int32)
        images.append({"img_id": f"{n:05d}.jpg", "captions": captions,
                       "mentions": mentions, "pairs": pairs,
                       "labels": labels})
    return images


def affinity_images(cfg: dict, n_images: int, seed: int) -> list[dict]:
    """``n_images`` affinity images (phrases are the mentions' spans); the
    box features are :func:`box_block`'s rows ``box_row`` onwards."""
    shape_rng = _rng(SHAPE_STREAM, 3)
    shapes = _caption_shapes(cfg, n_images, shape_rng)
    boxes = np.clip(1 + shape_rng.poisson(cfg["boxes_per_image_mean"] - 1.0,
                                          n_images),
                    1, cfg["boxes_per_image_max"])
    rng = _rng(seed, 4)
    order = rng.permutation(n_images)
    V = cfg["vocab_size"]
    images, row = [], 0
    for n, k in enumerate(order):
        captions, mentions, phrases = [], [], []
        for ci, (length, spans) in enumerate(shapes[k]):
            cap = rng.integers(1, V + 1, length).astype(np.int32)
            captions.append(cap)
            for f, l in _place(length, spans, rng):
                mentions.append((ci, f, l))
                phrases.append(cap[f:l + 1][:cfg["phrase_len"]].copy())
        nb = int(boxes[k])
        images.append({"img_id": f"{n:05d}.jpg", "captions": captions,
                       "mentions": mentions, "phrases": phrases,
                       "box_row": row, "n_boxes": nb})
        row += nb
    return images


def box_block(n_rows: int, box_dim: int, seed: int, device) -> np.ndarray:
    """The split's box features, float32 [n_rows, box_dim]: ReLU of normal
    draws, made on ``device`` in one call and copied to the host once."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed & (2 ** 63 - 1))
    x = torch.randn(n_rows, box_dim, generator=g, device=device)
    return torch.relu_(x).cpu().numpy()
