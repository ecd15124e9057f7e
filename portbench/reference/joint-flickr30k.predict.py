"""Plain reference of joint inference (ImageCaptionLearn_py's four task
models as ``icl-torch-joint --with_cardinality --with_rank`` runs them),
float32 with TF32 off, one model at a time.

* :func:`relation`: each caption through a BiLSTM over its own tokens (200
  units a direction); a mention is [fwd h; bwd h] at its first token then
  at its last (4H); a pair (i, j) is scored relu(m_i W1[:4H] + m_j W1[4H:]
  + b1) -> W2 + b2, softmax over the 4 classes.  The encoder and the pair
  logits are ``relation-flickr30k.train.py``'s (its forward, no dropout),
  loaded by path.
* :func:`affinity`: ``affinity-flickr30k.predict.py``, loaded by path: the
  phrase LSTM's final state, relu(h_a Wp + bp + f_b Wb) -> W2 + b2 over the
  4096-d box features, softmax over the 2 classes, and the ranking: the
  softmax of the affinity logit over the image's boxes.
* :func:`mention`: the nonvisual and the cardinality FFNN: the mean of the
  mention's word vectors (its true token count the divisor, at least 1),
  relu(x W1 + b1) -> W2 + b2, softmax over the classes (2 or 12).

Departures from the published description: none in the arithmetic.  The
mention span is capped at 16 tokens and a phrase at 16, as the port's data
layer caps them; the synthetic spans are at most 4 tokens, so no cap
applies.  Nothing here imports the program or a kernel of it.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

from portbench.reference import plain

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name: str):
    """A sibling reference file as a module, by its path."""
    spec = importlib.util.spec_from_file_location(
        "portbench_joint_ref_" + name.replace("-", "_").replace(".", "_"),
        os.path.join(HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_RELATION = _load("relation-flickr30k.train")
_AFFINITY = _load("affinity-flickr30k.predict")


def relation(p: dict, table: torch.Tensor, images: list[dict]) -> list:
    """Each image's pair probabilities [P, 4], pairs in ``pairs`` order, on
    the host."""
    if not images:
        return []
    with plain.exact_f32(), torch.no_grad():
        reps, offsets = _RELATION._encode(p, table, images)
        probs = torch.softmax(_RELATION._pair_logits(p, reps, offsets,
                                                     images), -1)
    out, k = [], 0
    for im in images:
        n = len(im["pairs"])
        out.append(probs[k:k + n].cpu().numpy())
        k += n
    return out


def affinity(p: dict, table: torch.Tensor, images: list[dict],
             boxes) -> list:
    """Each image's (probabilities [M, B, 2], ranking [M, B]) on the
    host; ``boxes`` is the split's box block (host float32 [rows, 4096])."""
    return _AFFINITY.predict(p, table, images, boxes) if images else []


def mention(p: dict, table: torch.Tensor, rows: list) -> np.ndarray:
    """Class probabilities [len(rows), C] of token-id rows, on the host."""
    dev = table.device
    with plain.exact_f32(), torch.no_grad():
        tokens, lengths = plain.pad_rows(rows, dev)
        T = tokens.shape[1]
        live = (torch.arange(T, device=dev)[None] < lengths[:, None])
        x = (table[tokens] * live[..., None]).sum(1) / torch.clamp_min(
            lengths[:, None].float(), 1.0)
        h = torch.relu(x @ p["dense_1/kernel"] + p["dense_1/bias"])
        logits = h @ p["dense_out/kernel"] + p["dense_out/bias"]
        return torch.softmax(logits, -1).cpu().numpy()
