"""Native-backed GoogleNews .bin loader (ctypes wrapper)."""

from __future__ import annotations

import ctypes

import numpy as np

from icl_torch.native import _load


def load_binary(path: str, restrict_to=None):
    """Returns (words, float32[V, D]) or None when native is unavailable.

    restrict_to: optional iterable of words — only matching entries are
    materialized (the gensim-era trick for GoogleNews-scale tables).
    """
    lib = _load()
    if lib is None:
        return None
    filt = b""
    if restrict_to is not None:
        filt = "\n".join(sorted(set(restrict_to))).encode("utf-8")
    handle = lib.w2v_load(path.encode(), filt)
    if not handle:
        import os

        if not os.path.exists(path):
            raise FileNotFoundError(path)
        # file exists but the native loader rejected it (unreadable, bad
        # header, oversized dim): fall back to the pure-Python loader,
        # whose behavior is the contract — a garbage header raises a
        # meaningful error, a truncated body keeps what parsed
        return None
    try:
        v = lib.w2v_vocab(handle)
        d = lib.w2v_dim(handle)
        wsize = lib.w2v_words_size(handle)
        table = np.empty((v, d), np.float32)
        words_buf = ctypes.create_string_buffer(max(int(wsize), 1))
        offsets = np.empty(max(v, 1), np.int64)
        lib.w2v_fill(
            ctypes.c_void_p(handle),
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            words_buf,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    finally:
        lib.w2v_free(ctypes.c_void_p(handle))
    raw = words_buf.raw
    words = []
    for i in range(v):
        off = int(offsets[i])
        words.append(raw[off:raw.index(b"\0", off)].decode("utf-8",
                                                           errors="replace"))
    return words, table
