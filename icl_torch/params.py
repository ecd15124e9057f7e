"""Weights: the ``icl-export`` flat ``.npz`` + manifest, as torch tensors.

The archive format is the one ``icl/cli/export.py`` writes: one ``.npz``
member per parameter leaf, keyed by its param-tree path with ``/``
separators and stored in sorted key order, plus ``<archive>.manifest.json``
with the step, each leaf's shape and dtype, the parameter total and the
``model_config``.  Layouts are the Keras ones the JAX package pins:

* ``caption_bilstm/{fwd,bwd}/kernel [D, 4H]``, ``recurrent_kernel [H, 4H]``,
  ``bias [4H]``, gate slabs in the order i, f, c~, o;
* ``head_dense/kernel [8H, K]``, ``head_dense/bias [K]``;
* ``head_out/kernel [K, O]``, ``head_out/bias [O]``.

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
        shapes[f"caption_bilstm/{d}/kernel"] = (D, 4 * H)
        shapes[f"caption_bilstm/{d}/recurrent_kernel"] = (H, 4 * H)
        shapes[f"caption_bilstm/{d}/bias"] = (4 * H,)
    shapes["head_dense/kernel"] = (8 * H, K)
    shapes["head_dense/bias"] = (K,)
    shapes["head_out/kernel"] = (K, O)
    shapes["head_out/bias"] = (O,)
    return shapes


def init_relation_params(seed: int, dims: dict,
                         generator: torch.Generator | None = None
                         ) -> dict[str, torch.Tensor]:
    """Fresh relation weights with the JAX package's initializer families.

    LSTM kernels glorot_uniform, recurrent kernels orthogonal, LSTM biases
    zeros with the forget slab at 1 (``icl/models/rnn.py``); Dense kernels
    lecun_normal (truncated at two standard deviations) and Dense biases
    zeros (``icl/models/_dense.py``).  Draws come from ``generator``, or
    from a CPU generator seeded with ``seed``; the values differ from JAX's
    for the same seed, the distributions do not.
    """
    gen = generator or torch.Generator().manual_seed(seed)
    out = {}
    for key, shape in relation_param_shapes(dims).items():
        if key.endswith("recurrent_kernel"):
            out[key] = _orthogonal(shape, gen)
        elif key.startswith("caption_bilstm") and key.endswith("kernel"):
            limit = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[key] = (torch.rand(shape, generator=gen) * 2 - 1) * limit
        elif key.startswith("caption_bilstm"):          # LSTM bias
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


def _orthogonal(shape: tuple[int, int], gen: torch.Generator) -> torch.Tensor:
    """flax ``orthogonal()`` for a 2-D [rows, cols] kernel."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (q.T if rows < cols else q).contiguous()


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
             model_config: dict | None = None, step: int = 0) -> dict:
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
    with open(path + ".manifest.json", "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    return manifest
