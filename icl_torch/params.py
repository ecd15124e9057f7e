"""Weights: the ``icl-export`` flat ``.npz`` + manifest, as torch tensors.

The archive format is the one ``icl/cli/export.py`` writes: one ``.npz``
member per parameter leaf, keyed by its param-tree path with ``/``
separators and stored in sorted key order, plus ``<archive>.manifest.json``
with the step, each leaf's shape and dtype, the parameter total and the
``model_config``.  Layouts are the Keras ones the JAX package pins:

* ``caption_bilstm/{fwd,bwd}/kernel [D, 4H]``, ``recurrent_kernel [H, 4H]``,
  ``bias [4H]``, gate slabs in the order i, f, c~, o;
* ``head_dense/kernel [8H, K]``, ``head_dense/bias [K]``;
* ``head_out/kernel [K, O]``, ``head_out/bias [O]``;
* affinity: ``phrase_lstm/{kernel,recurrent_kernel,bias}`` (absent with
  the ``mean_w2v`` phrase encoder), ``head_dense_phrase/{kernel,bias}``,
  ``head_dense_box/kernel [box_dim, K]`` (no bias) and ``head_out``;
* nonvisual and cardinality: ``dense_1/kernel [D, hidden]``,
  ``dense_1/bias [hidden]``, ``dense_out/kernel [hidden, C]``,
  ``dense_out/bias [C]`` (flax ``nn.Dense`` defaults).

The manifest's ``model_config`` names the task and the widths (``task``,
``emb_dim``, ``lstm_hidden``, ``head_hidden``, and for affinity
``phrase_enc`` and ``box_dim``; for the mention tasks ``hidden`` and
``num_classes``).

Loading and saving copy bytes and never convert, so an archive that goes
numpy -> torch -> numpy comes back byte-identical.
"""

from __future__ import annotations

import json
import math

import numpy as np
import torch


def relation_param_shapes(dims: dict) -> dict[str, tuple[int, ...]]:
    """Pinned relation-model keys -> shapes.

    ``dims``: ``emb_dim``, ``lstm_hidden``, ``head_hidden`` and optionally
    ``num_classes`` (default 4).
    """
    D, H = dims["emb_dim"], dims["lstm_hidden"]
    K, O = dims["head_hidden"], dims.get("num_classes", 4)
    shapes = {}
    for d in ("fwd", "bwd"):
        shapes.update(_lstm_shapes(f"caption_bilstm/{d}", D, H))
    shapes["head_dense/kernel"] = (8 * H, K)
    shapes["head_dense/bias"] = (K,)
    shapes["head_out/kernel"] = (K, O)
    shapes["head_out/bias"] = (O,)
    return shapes


def affinity_param_shapes(dims: dict) -> dict[str, tuple[int, ...]]:
    """Pinned affinity-model keys -> shapes (``icl/models/affinity.py``).

    ``dims``: ``emb_dim``, ``lstm_hidden``, ``head_hidden``, ``box_dim`` and
    optionally ``phrase_enc`` (``"lstm"``, the default, or ``"mean_w2v"``,
    which has no LSTM and projects the mean word vector) and
    ``num_classes`` (default 2).  The box side of the split head has no
    bias.
    """
    D, H = dims["emb_dim"], dims["lstm_hidden"]
    K, O = dims["head_hidden"], dims.get("num_classes", 2)
    shapes = {}
    if dims.get("phrase_enc", "lstm") == "lstm":
        shapes.update(_lstm_shapes("phrase_lstm", D, H))
        Dp = H
    else:
        Dp = D
    shapes["head_dense_phrase/kernel"] = (Dp, K)
    shapes["head_dense_phrase/bias"] = (K,)
    shapes["head_dense_box/kernel"] = (dims["box_dim"], K)
    shapes["head_out/kernel"] = (K, O)
    shapes["head_out/bias"] = (O,)
    return shapes


MENTION_NUM_CLASSES = {"nonvisual": 2, "cardinality": 12}


def mention_param_shapes(task: str):
    """Pinned keys -> shapes of a mention-task FFNN (``dims``: ``emb_dim``,
    ``hidden`` and optionally ``num_classes``, by default the task's)."""
    def shapes(dims: dict) -> dict[str, tuple[int, ...]]:
        D, Hd = dims["emb_dim"], dims["hidden"]
        C = dims.get("num_classes", MENTION_NUM_CLASSES[task])
        return {"dense_1/kernel": (D, Hd), "dense_1/bias": (Hd,),
                "dense_out/kernel": (Hd, C), "dense_out/bias": (C,)}
    return shapes


PARAM_SHAPES = {"relation": relation_param_shapes,
                "affinity": affinity_param_shapes,
                "nonvisual": mention_param_shapes("nonvisual"),
                "cardinality": mention_param_shapes("cardinality")}


def _lstm_shapes(prefix: str, D: int, H: int) -> dict[str, tuple[int, ...]]:
    return {f"{prefix}/kernel": (D, 4 * H),
            f"{prefix}/recurrent_kernel": (H, 4 * H),
            f"{prefix}/bias": (4 * H,)}


def init_params(task: str, seed: int, dims: dict,
                generator: torch.Generator | None = None
                ) -> dict[str, torch.Tensor]:
    """Fresh weights of ``task``'s model with the JAX package's initializer
    families.

    LSTM kernels glorot_uniform, recurrent kernels orthogonal, LSTM biases
    zeros with the forget slab at 1 (``icl/models/rnn.py``); Dense kernels
    lecun_normal (truncated at two standard deviations) and Dense biases
    zeros (``icl/models/_dense.py``).  Draws come from ``generator``, or
    from a CPU generator seeded with ``seed``; the values differ from JAX's
    for the same seed, the distributions do not.
    """
    gen = generator or torch.Generator().manual_seed(seed)
    out = {}
    for key, shape in PARAM_SHAPES[task](dims).items():
        lstm = "lstm/" in key
        if key.endswith("recurrent_kernel"):
            out[key] = _orthogonal(shape, gen)
        elif lstm and key.endswith("kernel"):
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[key] = (torch.rand(shape, generator=gen) * 2 - 1) * limit
        elif lstm:                                      # LSTM bias
            H = shape[0] // 4
            out[key] = torch.zeros(shape)
            out[key][H:2 * H] = 1.0
        elif key.endswith("kernel"):                    # Dense kernel
            # lecun_normal: stddev of the truncated normal is sqrt(1/fan_in)
            std = math.sqrt(1.0 / shape[0]) / 0.87962566103423978
            out[key] = torch.nn.init.trunc_normal_(
                torch.empty(shape), 0.0, std, -2 * std, 2 * std, generator=gen)
        else:                                           # Dense bias
            out[key] = torch.zeros(shape)
    return out


def init_relation_params(seed: int, dims: dict,
                         generator: torch.Generator | None = None
                         ) -> dict[str, torch.Tensor]:
    """:func:`init_params` of the relation model."""
    return init_params("relation", seed, dims, generator)


def _orthogonal(shape: tuple[int, int], gen: torch.Generator) -> torch.Tensor:
    """flax ``orthogonal()`` for a 2-D [rows, cols] kernel.

    The factorisation runs in float64 and is rounded once, by
    :func:`_householder_q`, whose every operation has one order wherever it
    runs: a threaded LAPACK (``torch.linalg.qr``, float32 or float64)
    blocks by the threads it finds free, which moved a float32 factor by
    1e-7 to 1e-5 between two calls, and a float64 one in its last bits,
    which still flips the float32 rounding of a value now and then; two
    ranks that start from one seed must draw the same bits."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen)
    q = torch.from_numpy(_householder_q(a.double().numpy())).float()
    return (q.T if rows < cols else q).contiguous()


def _householder_q(a: np.ndarray) -> np.ndarray:
    """Q of a = Q R for an [m, n] float64 array (m >= n), R's diagonal
    made positive, by Householder reflections: only elementwise products
    and numpy's single-threaded sums (``einsum`` without ``optimize``
    calls no BLAS), so the bits depend on the values alone, not on
    threads or blocking."""
    m, n = a.shape
    r = a.copy()
    vs, signs = [], np.ones(n)
    for j in range(n):
        x = r[j:, j]
        norm = np.sqrt(np.sum(x * x))
        alpha = -norm if x[0] >= 0 else norm     # R[j, j] after the step
        v = x.copy()
        v[0] -= alpha
        vv = np.sum(v * v)
        if vv > 0:
            v /= np.sqrt(vv)
            r[j:, j:] -= np.multiply.outer(2.0 * v,
                                           np.einsum("i,ij->j", v, r[j:, j:]))
        vs.append(v if vv > 0 else None)
        signs[j] = -1.0 if alpha < 0 else 1.0
    q = np.eye(m, n)
    for j in reversed(range(n)):
        v = vs[j]
        if v is not None:
            q[j:] -= np.multiply.outer(2.0 * v, np.einsum("i,ij->j", v, q[j:]))
    return q * signs


def load_npz(path: str) -> tuple[dict[str, torch.Tensor], dict]:
    """Read an archive and its manifest -> (key -> CPU tensor, manifest).

    Raises if the archive's keys, shapes or dtypes disagree with the
    manifest.
    """
    with open(path + ".manifest.json", encoding="utf-8") as f:
        manifest = json.load(f)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    spec = manifest.get("params", {})
    if sorted(spec) != sorted(arrays):
        raise ValueError(f"{path}: archive keys {sorted(arrays)} differ from "
                         f"the manifest's {sorted(spec)}")
    for k, a in arrays.items():
        if list(a.shape) != spec[k]["shape"] or str(a.dtype) != spec[k]["dtype"]:
            raise ValueError(f"{path}: {k} is {a.dtype}{list(a.shape)}, the "
                             f"manifest says {spec[k]['dtype']}"
                             f"{spec[k]['shape']}")
    return {k: torch.from_numpy(a) for k, a in arrays.items()}, manifest


def to_numpy(flat: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """key -> tensor back to key -> numpy array, bytes unchanged."""
    return {k: v.detach().cpu().numpy() for k, v in flat.items()}


def save_npz(path: str, flat: dict[str, torch.Tensor],
             model_config: dict | None = None, step: int = 0,
             train_config: dict | None = None) -> dict:
    """Write ``path`` (.npz) + ``path``.manifest.json as ``icl-export``
    does; returns the manifest."""
    arrays = dict(sorted(to_numpy(flat).items()))
    np.savez(path, **arrays)
    manifest: dict = {
        "step": int(step),
        "params": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "total_parameters": int(sum(v.size for v in arrays.values())),
    }
    if model_config is not None:
        manifest["model_config"] = model_config
    if train_config is not None:
        manifest["train_config"] = train_config
    with open(path + ".manifest.json", "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    return manifest
