"""The benchmark's side of the program's entries: the generated images as
the program's dataset records, the precision a cell states, the device's
synchronisation and memory peak.  The program is the ``icl_torch``
package, imported only here and in the drivers."""

from __future__ import annotations

import numpy as np
import torch


def set_precision(mode: str, device: torch.device, predict: bool,
                  tf32: bool | None = None):
    """The program's resolution of ``--matmul_precision`` (``default``,
    ``high`` or ``highest``) set as its command lines set it; ``tf32``
    overrides the TF32 flag (the control's lower precision)."""
    from icl_torch.cli._common import precision_policy

    prec = precision_policy(mode, torch.device(device).type, predict)
    on = prec.tf32 if tf32 is None else tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return prec


def relation_dataset(images: list[dict]):
    """Generated relation images as the program's ``RelationDataset``."""
    from icl_torch.data.pipeline import RelationDataset, RelationImage

    out = []
    for im in images:
        caps = im["captions"]
        tokens = np.zeros((len(caps), max(len(c) for c in caps)), np.int32)
        for c, t in enumerate(caps):
            tokens[c, :len(t)] = t
        men = np.asarray(im["mentions"], np.int32).reshape(-1, 3)
        within = np.zeros(len(men), np.int32)     # mention index in caption
        for r in range(1, len(men)):
            within[r] = within[r - 1] + 1 if men[r, 0] == men[r - 1, 0] else 0
        pij = np.asarray(im["pairs"], np.int32).reshape(-1, 2)
        key = np.stack([men[pij[:, 0], 0], within[pij[:, 0]],
                        men[pij[:, 1], 0], within[pij[:, 1]]], 1)
        out.append(RelationImage(
            img_id=im["img_id"], tokens=tokens,
            tok_len=np.asarray([len(c) for c in caps], np.int32),
            m_cap=men[:, 0].copy(), m_first=men[:, 1].copy(),
            m_last=men[:, 2].copy(), pair_ij=pij,
            pair_label=np.asarray(im["labels"], np.int32),
            pair_key=key.astype(np.int32)))
    return RelationDataset(images=out)


def affinity_dataset(images: list[dict], boxes: np.ndarray, L: int):
    """Generated affinity images as the program's ``AffinityDataset``; the
    box features are views of the split's block."""
    from icl_torch.data.pipeline import AffinityDataset, AffinityImage

    out = []
    for im in images:
        M, nb = len(im["phrases"]), im["n_boxes"]
        pt = np.zeros((M, L), np.int32)
        for r, ph in enumerate(im["phrases"]):
            pt[r, :len(ph)] = ph
        within, ids = {}, []
        for c, _, _ in im["mentions"]:
            within[c] = within.get(c, -1) + 1
            ids.append(f"doc:{im['img_id']};caption:{c};mention:{within[c]}")
        out.append(AffinityImage(
            img_id=im["img_id"], phrase_tokens=pt,
            phrase_len=np.asarray([len(p) for p in im["phrases"]], np.int32),
            mention_ids=ids,
            box_feats=boxes[im["box_row"]:im["box_row"] + nb],
            box_idx=list(range(nb)),
            grid_label=np.zeros((M, nb), np.int32),
            grid_valid=np.ones((M, nb), bool)))
    return AffinityDataset(images=out, box_dim=boxes.shape[1])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))
