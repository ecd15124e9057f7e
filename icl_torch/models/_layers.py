"""Pieces the task models share.

* :class:`Dense`: a parameter-only Dense layer (counterpart of
  ``icl/models/_dense.py``): ``kernel [in, out]`` and, unless ``use_bias``
  is off, ``bias [out]``, in the Keras layout the JAX package pins.  The
  models apply them themselves (``x @ kernel + bias``) or hand them to a
  kernel.
* :class:`FlatParams`: a model's weights keyed by ``icl-export`` paths
  (``head_out/bias``, ...), in and out.
"""

from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
    """``kernel [in, out]`` and ``bias [out]`` (or no bias)."""

    def __init__(self, in_features: int, features: int,
                 device: torch.device | None = None, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features,
                                               device=device))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features, device=device))


class FlatParams(nn.Module):
    """``load_flat`` / ``flat_params`` over the ``icl-export`` keys: the
    submodule names follow the pinned param-tree paths, with ``/`` for
    ``.``."""

    def load_flat(self, flat: dict[str, torch.Tensor]) -> None:
        """Copy ``icl-export`` keyed weights in; raises on any key or shape
        mismatch."""
        self.load_state_dict({k.replace("/", "."): v
                              for k, v in flat.items()})

    def flat_params(self) -> dict[str, torch.Tensor]:
        return {k.replace(".", "/"): v for k, v in self.state_dict().items()}
