"""Vectorized mention-pair enumeration (target of SURVEY.md §4.1).

Reference parity: the reference built O(M²) mention pairs per image in nested
Python loops (SURVEY §3.1 C7, BASELINE.json north_star).  Here enumeration is
a single numpy pass producing index tables; the actual pair *tensor* is never
materialized on host — the model gathers mention representations on-device
(XLA gather, or the fused grid-head Pallas kernel K1 in icl.ops.grid_head —
see ARCHITECTURE.md §3.2 for the K1 reinterpretation).

Convention: each unordered pair (i < j in global mention order: caption index
then mention index) appears once; direction is carried by the 4-way label
``{null=0, coref=1, subset_ij=2, subset_ji=3}`` (SURVEY §6.4).

The port's own copy of ``icl/data/pairs.py``: ``icl_torch`` imports
nothing of the JAX package, and ``tests/test_torch_data.py`` holds the two
copies to the same outputs.  Rationale below is the original's; where it
names XLA or the TPU, read PyTorch and the GPU.
"""

from __future__ import annotations

import numpy as np

from icl_torch.io.captions import Mention, make_pair_id

RELATION_CLASSES = ("null", "coref", "subset_ij", "subset_ji")


def enumerate_pairs(mentions: list[Mention]) -> tuple[np.ndarray, list[str]]:
    """All unordered cross/within-caption mention pairs of one image.

    Args:
      mentions: mentions of a single image, any order.

    Returns:
      (int32[P, 2] index pairs into the *sorted* mention list,
       pair id strings in the §6.1 scheme), with mentions sorted by
      (caption_idx, mention_idx) and i < j in that order.
    """
    order = sorted(range(len(mentions)),
                   key=lambda k: (mentions[k].cap_idx, mentions[k].mention_idx))
    ms = [mentions[k] for k in order]
    n = len(ms)
    if n < 2:
        return np.zeros((0, 2), dtype=np.int32), []
    iu, ju = np.triu_indices(n, k=1)
    ids = [
        make_pair_id(ms[i].img_id, ms[i].cap_idx, ms[i].mention_idx,
                     ms[j].cap_idx, ms[j].mention_idx)
        for i, j in zip(iu.tolist(), ju.tolist())
    ]
    return np.stack([iu, ju], axis=1).astype(np.int32), ids
