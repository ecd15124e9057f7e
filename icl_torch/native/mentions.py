"""Native-backed columnar mentions.txt parsing (ctypes wrapper)."""

from __future__ import annotations

import ctypes

import numpy as np

from icl_torch.native import _load


def parse_mentions(path: str):
    """C++ columnar parse of ``mentions.txt`` (icl_native.cpp
    mentions_parse).

    Returns ``(docs list[str], doc_idx i32[n], cap i32[n], men i32[n],
    first i32[n], last i32[n])`` — ``docs`` in first-appearance order —
    or None when the native library is unavailable or ANY line deviates
    from the strict grammar (callers then use
    :func:`icl_torch.io.captions.read_mentions`, which reproduces the exact
    per-line error behavior).  Raises FileNotFoundError like the Python
    reader when the file cannot be opened."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.mentions_parse(path.encode())
    if not handle:
        import os

        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return None   # unreadable: the Python path raises the real error
    try:
        if int(lib.men_fallback(ctypes.c_void_p(handle))):
            from icl_torch.native import warn_demoted
            warn_demoted(path, int(lib.men_fallback_line(
                ctypes.c_void_p(handle))), "mentions")
            return None
        n = int(lib.men_num(ctypes.c_void_p(handle)))
        ndocs = int(lib.men_num_docs(ctypes.c_void_p(handle)))
        docs_size = int(lib.men_docs_size(ctypes.c_void_p(handle)))
        cols = [np.empty(max(n, 1), np.int32) for _ in range(5)]
        docs_buf = ctypes.create_string_buffer(max(docs_size, 1))
        lib.men_fill(
            ctypes.c_void_p(handle),
            *(c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
              for c in cols),
            docs_buf)
    finally:
        lib.men_free(ctypes.c_void_p(handle))
    docs = (docs_buf.raw[:docs_size].decode("utf-8").split("\0")[:ndocs]
            if ndocs else [])
    cap, men, first, last, doc_idx = (c[:n] for c in cols)
    return docs, doc_idx, cap, men, first, last
