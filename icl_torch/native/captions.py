"""Native-backed captions.txt tokenization (ctypes wrapper)."""

from __future__ import annotations

import ctypes

import numpy as np

from icl_torch.native import _load


def caption_words(path: str):
    """Unique caption words via C++ (native captions_words) — the
    embedding-prune vocabulary of icl_torch.cli._common.split_vocab.  Returns a
    set[str], or None when native is unavailable or a key deviates from
    the strict grammar (callers then use the read_captions path for its
    exact errors).  Rows containing non-ASCII bytes come back raw and are
    split here with Python's Unicode str.split()."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.captions_words(path.encode())
    if not handle:
        import os

        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return None   # unreadable: the Python path raises the real error
    try:
        if int(lib.cap_fallback(ctypes.c_void_p(handle))):
            from icl_torch.native import warn_demoted
            warn_demoted(path, int(lib.cap_fallback_line(
                ctypes.c_void_p(handle))), "captions")
            return None
        ndocs = int(lib.cap_num_docs(ctypes.c_void_p(handle)))
        docs_size = int(lib.cap_docs_size(ctypes.c_void_p(handle)))
        nflag = int(lib.cap_num_flagged(ctypes.c_void_p(handle)))
        flag_bytes = int(lib.cap_flagged_bytes(ctypes.c_void_p(handle)))
        one32 = np.empty(1, np.int32)
        offsets = np.empty(1, np.int64)
        ids1 = np.empty(1, np.int32)
        docs_buf = ctypes.create_string_buffer(max(docs_size, 1))
        flag_rows = np.empty(max(nflag, 1), np.int64)
        flag_buf = ctypes.create_string_buffer(max(flag_bytes, 1))
        lib.cap_fill(
            ctypes.c_void_p(handle),
            one32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            one32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ids1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            docs_buf,
            flag_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            flag_buf)
    finally:
        lib.cap_free(ctypes.c_void_p(handle))
    words: set[str] = set()
    if ndocs:
        words.update(docs_buf.raw[:docs_size].decode("utf-8")
                     .split("\0")[:ndocs])
    if nflag:
        try:
            texts = flag_buf.raw[:flag_bytes].decode("utf-8").split("\0")
        except UnicodeDecodeError:
            return None
        for t in texts[:nflag]:
            words.update(t.split())
    return words


def parse_captions(path: str, vocab_words: list[str]):
    """C++ single-pass parse + vocab-row encode of ``captions.txt``
    (icl_native.cpp captions_parse).

    ``vocab_words`` must be the embedding vocabulary in table-row order
    (row 1 first — row 0 is PAD/OOV).  Returns ``(docs list[str],
    doc_idx i32[n], cap_idx i32[n], offsets i64[n+1], ids i32[T],
    flagged dict[row -> raw token text])`` — flagged rows carry no ids
    and must be re-encoded by the caller (their token region contains
    non-ASCII bytes, where only Python's Unicode split/lower semantics
    are exact).  Returns None when the native library is unavailable,
    a key deviates from the strict grammar (caller re-reads with
    read_captions for its exact errors), or a flagged row is not valid
    UTF-8."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.captions_parse(path.encode(),
                                "\n".join(vocab_words).encode())
    if not handle:
        import os

        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return None   # unreadable: the Python path raises the real error
    try:
        if int(lib.cap_fallback(ctypes.c_void_p(handle))):
            from icl_torch.native import warn_demoted
            warn_demoted(path, int(lib.cap_fallback_line(
                ctypes.c_void_p(handle))), "captions")
            return None
        n = int(lib.cap_num(ctypes.c_void_p(handle)))
        ndocs = int(lib.cap_num_docs(ctypes.c_void_p(handle)))
        docs_size = int(lib.cap_docs_size(ctypes.c_void_p(handle)))
        total = int(lib.cap_ids_total(ctypes.c_void_p(handle)))
        nflag = int(lib.cap_num_flagged(ctypes.c_void_p(handle)))
        flag_bytes = int(lib.cap_flagged_bytes(ctypes.c_void_p(handle)))
        cap_idx = np.empty(max(n, 1), np.int32)
        doc_idx = np.empty(max(n, 1), np.int32)
        offsets = np.empty(n + 1, np.int64)
        ids = np.empty(max(total, 1), np.int32)
        docs_buf = ctypes.create_string_buffer(max(docs_size, 1))
        flag_rows = np.empty(max(nflag, 1), np.int64)
        flag_buf = ctypes.create_string_buffer(max(flag_bytes, 1))
        lib.cap_fill(
            ctypes.c_void_p(handle),
            cap_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            doc_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            docs_buf,
            flag_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            flag_buf)
    finally:
        lib.cap_free(ctypes.c_void_p(handle))
    try:
        # doc ids may carry non-ASCII bytes; invalid UTF-8 must fall back
        # (read_captions raises its own UnicodeDecodeError with file
        # context), not escape this wrapper as a bare buffer decode error
        docs = (docs_buf.raw[:docs_size].decode("utf-8").split("\0")[:ndocs]
                if ndocs else [])
    except UnicodeDecodeError:
        return None
    flagged: dict[int, str] = {}
    if nflag:
        try:
            texts = flag_buf.raw[:flag_bytes].decode("utf-8").split("\0")
        except UnicodeDecodeError:
            return None   # read_captions raises its own decode error
        flagged = {int(r): t for r, t in zip(flag_rows[:nflag], texts)}
    return docs, doc_idx[:n], cap_idx[:n], offsets, ids[:total], flagged
