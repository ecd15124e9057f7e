"""Keras-3 CPU oracle for score parity (the port's copy of
``icl/eval/oracle.py``).

Every learned op (LSTM cells, Dense layers) is executed through
``keras.layers`` on the CPU with weights copied from the port's params, and
the parity gate is max |p_port - p_oracle| <= 1e-5 in f32 (``--oracle-parity``,
:func:`icl_torch.cli._common.report_parity`).  The params are the port's
flat pinned-path dict (``caption_bilstm/fwd/kernel``, ...,
``icl_torch.params``) as numpy arrays; they are unflattened on ``/`` into
the nested tree the original reads, so the two oracles compute the same
values from the same weights (tests/test_torch_oracle.py holds them to equal
bits).

Stage composition (gathers, concatenation, softmax normalization of the
ranking path) is numpy mirroring the documented architecture — the learned
math itself always goes through Keras.  Keras runs on the torch backend
and is imported once, at the first call; with ``KERAS_BACKEND=torch`` it
places tensors on CUDA whenever a card is visible, so every layer is built
and called under ``keras.device("cpu")``.
"""

from __future__ import annotations

import numpy as np

# keras import is deferred so the GPU path never pays for it
_keras = None


def _k():
    global _keras
    if _keras is None:
        import os
        os.environ.setdefault("KERAS_BACKEND", "torch")
        import keras
        _keras = keras
    return _keras


def _unflatten(params: dict) -> dict:
    """``{"a/b/c": x}`` -> ``{"a": {"b": {"c": x}}}``; keys without ``/``
    (a tree already nested) pass through."""
    tree: dict = {}
    for key, value in params.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def keras_lstm(weights: dict, x: np.ndarray, lengths: np.ndarray,
               go_backwards: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Run keras.layers.LSTM with our fused weights; returns (seq, final_h).

    weights: {"kernel" [D,4H], "recurrent_kernel" [H,4H], "bias" [4H]}.
    Masking: explicit bool mask (t < length).  For ``go_backwards`` the
    returned sequence is re-reversed into original time order to match
    icl_torch.models.rnn.LSTM(reverse=True).
    """
    keras = _k()
    H = weights["bias"].shape[0] // 4
    x = np.asarray(x, np.float32)
    mask = (np.arange(x.shape[1])[None, :] < np.asarray(lengths)[:, None])
    import torch
    with keras.device("cpu"), torch.no_grad():
        layer = keras.layers.LSTM(H, return_sequences=True,
                                  return_state=True,
                                  go_backwards=go_backwards)
        layer.build(x.shape)
        layer.set_weights([np.asarray(weights["kernel"], np.float32),
                           np.asarray(weights["recurrent_kernel"], np.float32),
                           np.asarray(weights["bias"], np.float32)])
        out = layer(keras.ops.convert_to_tensor(x),
                    mask=keras.ops.convert_to_tensor(mask))
        seq, final_h = (np.asarray(out[0]), np.asarray(out[1]))
    if go_backwards:
        seq = seq[:, ::-1]
    return seq, final_h


def keras_dense(kernel: np.ndarray, bias: np.ndarray | None, x: np.ndarray,
                activation: str | None = None) -> np.ndarray:
    keras = _k()
    units = kernel.shape[1]
    flat = np.asarray(x, np.float32).reshape(-1, kernel.shape[0])
    import torch
    with keras.device("cpu"), torch.no_grad():
        layer = keras.layers.Dense(units, activation=activation,
                                   use_bias=bias is not None)
        layer.build(flat.shape)
        layer.set_weights([np.asarray(kernel, np.float32)]
                          + ([np.asarray(bias, np.float32)]
                             if bias is not None else []))
        out = np.asarray(layer(keras.ops.convert_to_tensor(flat)))
    return out.reshape(x.shape[:-1] + (units,))


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# ---------------------------------------------------------------------------
# Full-model oracles (params: the flat pinned-path dict, numpy arrays)
# ---------------------------------------------------------------------------

def oracle_ffnn(params: dict, pooled: np.ndarray) -> np.ndarray:
    """Nonvisual/cardinality oracle: Dense(relu) → Dense → softmax (§6.3)."""
    params = _unflatten(params)
    h = keras_dense(params["dense_1"]["kernel"], params["dense_1"]["bias"],
                    pooled, activation="relu")
    logits = keras_dense(params["dense_out"]["kernel"],
                         params["dense_out"]["bias"], h)
    return _softmax(logits)


def oracle_bilstm(params: dict, x: np.ndarray, lengths: np.ndarray):
    """BiLSTM oracle matching icl_torch.models.rnn.BiLSTM:
    ([B,L,2H], [B,2H])."""
    params = _unflatten(params)
    f_seq, f_h = keras_lstm(params["fwd"], x, lengths, go_backwards=False)
    b_seq, b_h = keras_lstm(params["bwd"], x, lengths, go_backwards=True)
    return (np.concatenate([f_seq, b_seq], -1),
            np.concatenate([f_h, b_h], -1))


def oracle_relation(params: dict, emb_table: np.ndarray,
                    batch: dict) -> np.ndarray:
    """Relation oracle: probs [I, P, 4] matching RelationModel (§6.4)."""
    params = _unflatten(params)
    tokens, tok_len = batch["tokens"], batch["tok_len"]
    I, C, L = tokens.shape
    x = emb_table[tokens.reshape(I * C, L)]
    enc, _ = oracle_bilstm(params["caption_bilstm"], x, tok_len.reshape(I * C))
    twoH = enc.shape[-1]
    enc = enc.reshape(I, C, L, twoH)
    ii = np.arange(I)[:, None]
    cap = batch["m_cap"]
    first_rep = enc[ii, cap, batch["m_first"]]
    last_rep = enc[ii, cap, batch["m_last"]]
    mreps = np.concatenate([first_rep, last_rep], -1)      # [I,M,4H]
    rep_i = mreps[ii, batch["pair_ij"][:, :, 0]]
    rep_j = mreps[ii, batch["pair_ij"][:, :, 1]]
    preps = np.concatenate([rep_i, rep_j], -1)             # [I,P,8H]
    h = keras_dense(params["head_dense"]["kernel"],
                    params["head_dense"]["bias"], preps, activation="relu")
    logits = keras_dense(params["head_out"]["kernel"],
                         params["head_out"]["bias"], h)
    return _softmax(logits)


def oracle_affinity(params: dict, emb_table: np.ndarray, batch: dict,
                    phrase_enc: str = "lstm") -> np.ndarray:
    """Affinity oracle: probs [I, M, B, 2] matching AffinityModel (§6.5).

    The oracle applies the head to the *explicit concat* [phrase; fc7] with
    W = [W_p; W_b] stacked — verifying the split-GEMM restructuring against
    the reference formulation, not just re-running it.
    """
    params = _unflatten(params)
    toks, plen = batch["phrase_tokens"], batch["phrase_len"]
    boxes = batch["box_feats"]
    I, M, L = toks.shape
    B = boxes.shape[1]
    x = emb_table[toks.reshape(I * M, L)]
    if phrase_enc == "lstm":
        _, ph = keras_lstm(params["phrase_lstm"], x, plen.reshape(I * M))
    else:
        mask = (np.arange(L)[None] < plen.reshape(I * M)[:, None]
                ).astype(np.float32)
        ph = (x * mask[..., None]).sum(1) / np.maximum(
            plen.reshape(I * M, 1).astype(np.float32), 1.0)
    phrase = ph.reshape(I, M, -1)
    # reference-style concat head: W = [W_p; W_b], bias from the phrase side
    W = np.concatenate([params["head_dense_phrase"]["kernel"],
                        params["head_dense_box"]["kernel"]], axis=0)
    bias = params["head_dense_phrase"]["bias"]
    pe = np.broadcast_to(phrase[:, :, None, :], (I, M, B, phrase.shape[-1]))
    be = np.broadcast_to(boxes[:, None, :, :], (I, M, B, boxes.shape[-1]))
    concat = np.concatenate([pe, be], -1)                  # [I,M,B,Dp+Db]
    h = keras_dense(W, bias, concat, activation="relu")
    logits = keras_dense(params["head_out"]["kernel"],
                         params["head_out"]["bias"], h)
    return _softmax(logits)
