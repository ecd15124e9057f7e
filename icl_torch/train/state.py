"""Train state: model + Adam + step counter + dropout seed.

Counterpart of ``icl/train/state.py``.  ``optax.adam(lr)`` and
``torch.optim.Adam(lr)`` share their defaults (b1 0.9, b2 0.999, eps 1e-8)
and their formula (bias-corrected moments, eps outside the square root).
The per-step dropout seeds come from a numpy generator seeded from (seed,
step), the counterpart of ``TrainState.step_rng``'s ``fold_in``: a step's
seeds depend on nothing but the run's seed and the step number.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from icl_torch.params import init_params, load_npz


@dataclasses.dataclass
class TrainState:
    model: nn.Module      # one of the four task models
    optimizer: torch.optim.Optimizer
    seed: int
    step: int = 0

    def dropout_seeds(self, n_global: int,
                      rows: tuple[int, int] | None = None) -> torch.Tensor:
        """This step's dropout seeds, one per image (relation, affinity) or
        per row (the mention tasks): int32 in [0, 2**31-1), on the model's
        device.  Drawn for the GLOBAL batch of ``n_global`` rows as a pure
        function of (seed, step); ``rows=(lo, hi)`` returns the seeds of
        those rows, so a rank that feeds rows [lo, hi) of a sharded batch
        masks them as one process would.  Both numbers enter a
        ``SeedSequence`` (torch's CPU generator would keep only the low 32
        bits of one packed 64-bit seed, which dropped the run's seed)."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed & 0xFFFFFFFF, self.step & 0xFFFFFFFF]))
        seeds = rng.integers(0, 2 ** 31 - 1, n_global, dtype=np.int32)
        if rows is not None:
            seeds = seeds[rows[0]:rows[1]]
        return torch.from_numpy(seeds).to(
            next(self.model.parameters()).device)

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor of the state, in a fixed order: the model's
        ``state_dict``, then Adam's per-parameter state."""
        return list(self.named_tensors().values())

    def named_tensors(self) -> dict[str, torch.Tensor]:
        """:meth:`tensors` by name: the ``state_dict`` keys, then
        ``adam/<parameter>/<key>`` (``exp_avg``, ``exp_avg_sq``, ``step``)."""
        out = dict(self.model.state_dict())
        params = [n for n, _ in self.model.named_parameters()]
        for i, st in sorted(self.optimizer.state_dict()["state"].items()):
            out.update({f"adam/{params[i]}/{k}": v for k, v in
                        sorted(st.items()) if isinstance(v, torch.Tensor)})
        return out

    def apply_gradients(self) -> None:
        """One Adam update from the parameters' ``.grad``; step += 1."""
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, seed: int = 0,
                       learn_rate: float = 1e-3,
                       params: str | dict | None = None) -> TrainState:
    """Load the model's weights and start Adam.

    ``model``: one of the task models
    (:class:`~icl_torch.models.relation.RelationModel`,
    :class:`~icl_torch.models.affinity.AffinityModel`,
    :class:`~icl_torch.models.nonvisual.NonvisualModel`,
    :class:`~icl_torch.models.cardinality.CardinalityModel`): anything with
    ``task``, ``dims`` and ``load_flat``.  ``params``: None
    draws fresh weights (:func:`~icl_torch.params.init_params` of the
    model's task, from ``seed``); a path loads an ``icl-export`` archive; a
    dict of key -> tensor or numpy array is loaded as it is.
    """
    if params is None:
        params = init_params(model.task, seed, model.dims)
    elif isinstance(params, str):
        params, _ = load_npz(params)
    model.load_flat({k: torch.as_tensor(v) for k, v in params.items()})
    opt = torch.optim.Adam(model.parameters(), lr=learn_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model=model, optimizer=opt, seed=seed)
