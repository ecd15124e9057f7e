"""Seeded weights and word vectors, made on the device in two large calls.

The keys and layouts are the models' published ones (Keras: ``kernel [in,
out]``, ``recurrent_kernel [H, 4H]``, gate slabs i, f, c~, o), written here
from the configuration so that the plain reference and the program are
handed the same tensors.  Scales follow the Keras initialisers (glorot for
the LSTM input kernel, 1/sqrt(H) for the recurrent kernel, lecun for Dense
kernels); biases get small draws (the LSTM forget slab 1 plus a draw) so
every bias path carries signal.
"""

from __future__ import annotations

import math

import torch


def _lstm(prefix: str, D: int, H: int) -> dict:
    return {f"{prefix}/kernel": ((D, 4 * H), math.sqrt(2.0 / (D + 4 * H))),
            f"{prefix}/recurrent_kernel": ((H, 4 * H), 1.0 / math.sqrt(H)),
            f"{prefix}/bias": ((4 * H,), 0.05)}


def param_specs(cfg: dict) -> dict[str, tuple[tuple[int, ...], float]]:
    """key -> (shape, standard deviation) of the configuration's model."""
    D, H, K = cfg["emb_dim"], cfg["lstm_hidden"], cfg["head_hidden"]
    O = cfg["num_classes"]
    if cfg["model"] == "relation":
        specs = {**_lstm("caption_bilstm/fwd", D, H),
                 **_lstm("caption_bilstm/bwd", D, H),
                 "head_dense/kernel": ((8 * H, K), math.sqrt(1.0 / (8 * H))),
                 "head_dense/bias": ((K,), 0.05)}
    else:
        specs = {**_lstm("phrase_lstm", D, H),
                 "head_dense_phrase/kernel": ((H, K), math.sqrt(1.0 / H)),
                 "head_dense_phrase/bias": ((K,), 0.05),
                 "head_dense_box/kernel": ((cfg["box_dim"], K),
                                           math.sqrt(1.0 / cfg["box_dim"]))}
    specs["head_out/kernel"] = ((K, O), math.sqrt(1.0 / K))
    specs["head_out/bias"] = ((O,), 0.05)
    return specs


def make_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The model's weights, f32 on ``device``, from one normal draw."""
    specs = param_specs(cfg)
    sizes = [math.prod(shape) for shape, _ in specs.values()]
    g = torch.Generator(device=device).manual_seed((seed * 2 + 1)
                                                   & (2 ** 63 - 1))
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out = {}
    for (key, (shape, std)), part in zip(specs.items(),
                                         flat.split(sizes)):
        w = part.reshape(shape) * std
        if "lstm" in key and key.endswith("/bias"):
            H = shape[0] // 4
            w[H:2 * H] += 1.0          # the forget slab
        out[key] = w.contiguous()
    return out


def make_table(cfg: dict, seed: int, device) -> torch.Tensor:
    """Word vectors, f32 [vocab + 1, emb_dim] on ``device``; row 0 is the
    zero PAD row."""
    g = torch.Generator(device=device).manual_seed((seed * 2 + 2)
                                                   & (2 ** 63 - 1))
    t = torch.randn(cfg["vocab_size"] + 1, cfg["emb_dim"], generator=g,
                    device=device) * 0.15
    t[0] = 0.0
    return t
