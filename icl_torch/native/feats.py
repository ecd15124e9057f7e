"""Native-backed `.feats` parsing and `.scores` writing (ctypes wrappers)."""

from __future__ import annotations

import ctypes

import numpy as np

from icl_torch.native import _load


def _warn_skipped(path: str, skipped: int) -> None:
    """Malformed lines are dropped whole (identically by the native and
    pure-Python parsers — tests/test_torch_native.py) but never silently."""
    if skipped:
        from icl_torch.util.log import LOG
        LOG.warning("%s: skipped %d malformed line(s)", path, skipped)


def parse_feats_file(path: str):
    """Returns [(id, label, int32 indices, float32 values), ...] or None."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.feats_parse(path.encode())
    if not handle:
        import os

        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return None   # unreadable: the Python path raises the real error
    try:
        if int(lib.feats_needs_python(ctypes.c_void_p(handle))):
            # non-ASCII could change tokenization — Python path
            from icl_torch.native import warn_demoted
            warn_demoted(path, int(lib.feats_fallback_line(
                ctypes.c_void_p(handle))), "feats")
            return None
        n = lib.feats_num_examples(handle)
        nnz = lib.feats_num_entries(handle)
        idlen = lib.feats_id_buffer_size(handle)
        _warn_skipped(path, int(lib.feats_num_skipped(handle)))
        labels = np.empty(n, np.float64)
        row_offsets = np.empty(n + 1, np.int32)
        indices = np.empty(max(nnz, 1), np.int32)
        values = np.empty(max(nnz, 1), np.float32)
        id_buffer = ctypes.create_string_buffer(max(int(idlen), 1))
        id_offsets = np.empty(max(n, 1), np.int64)
        lib.feats_fill(
            ctypes.c_void_p(handle),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            row_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            id_buffer,
            id_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    finally:
        lib.feats_free(ctypes.c_void_p(handle))
    raw = id_buffer.raw
    out = []
    for i in range(n):
        off = int(id_offsets[i])
        eid = "" if off < 0 else raw[off:raw.index(b"\0", off)].decode("utf-8")
        s, e = int(row_offsets[i]), int(row_offsets[i + 1])
        out.append((eid, float(labels[i]), indices[s:e].copy(),
                    values[s:e].copy()))
    return out


def parse_feats_labels(path: str):
    """Labels-only parse: returns (ids list, labels float64 array) or None.

    The dataset loaders consume only (id, label); skipping the sparse
    feature columns keeps MSCOCO-scale loads fast and bounded
    (icl_native.cpp feats_parse_labels)."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.feats_parse_labels(path.encode())
    if not handle:
        import os

        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return None   # unreadable: the Python path raises the real error
    try:
        if int(lib.featsl_needs_python(ctypes.c_void_p(handle))):
            # non-ASCII could change tokenization — Python path
            from icl_torch.native import warn_demoted
            warn_demoted(path, int(lib.featsl_fallback_line(
                ctypes.c_void_p(handle))), "feats")
            return None
        n = int(lib.featsl_num(handle))
        idlen = int(lib.featsl_id_buffer_size(handle))
        _warn_skipped(path, int(lib.featsl_num_skipped(handle)))
        labels = np.empty(max(n, 1), np.float64)
        id_offsets = np.empty(max(n, 1), np.int64)
        id_buffer = ctypes.create_string_buffer(max(idlen, 1))
        lib.featsl_fill(
            ctypes.c_void_p(handle),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            id_buffer,
            id_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    finally:
        lib.featsl_free(ctypes.c_void_p(handle))
    raw = id_buffer.raw[:idlen]
    if n and (id_offsets[:n] >= 0).all():
        # common case (every line carries an id): one C-speed split
        ids = raw.decode("utf-8").split("\0")[:n]
    else:
        ids = []
        for i in range(n):
            off = int(id_offsets[i])
            ids.append("" if off < 0
                       else raw[off:raw.index(b"\0", off)].decode("utf-8"))
    return ids, labels[:n]


_ID_KINDS = {"mention": (0, 2), "pair": (1, 4), "affinity": (2, 3)}


def parse_feats_ids(path: str, kind: str):
    """Combined labels + example-id table parse (no Python id strings).

    Parses a `.feats` file and every example id under the §6.1 ``kind``
    grammar (``mention``/``pair``/``affinity``) entirely in C++, returning
    ``(labels f64[n], fields i32[n,k], doc_idx i32[n], docs list[str],
    overrides dict[row -> exact id str])`` — ``docs`` in first-appearance
    order, ``overrides`` holding the verbatim ids of zero-padded rows.

    Returns None when the native library is unavailable OR any id deviates
    from the grammar (including int32-overflowing fields and missing id
    comments): callers must then take the pure-Python path, which
    reproduces the exact per-row error/skip behavior.  Dataset-level
    equality with that path is tested (tests/test_torch_native.py)."""
    lib = _load()
    if lib is None:
        return None
    knum, k = _ID_KINDS[kind]
    handle = lib.feats_parse_labels(path.encode())
    if not handle:
        import os

        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return None   # unreadable: the Python path raises the real error
    table = None
    try:
        if int(lib.featsl_needs_python(ctypes.c_void_p(handle))):
            # non-ASCII could change tokenization — Python path
            from icl_torch.native import warn_demoted
            warn_demoted(path, int(lib.featsl_fallback_line(
                ctypes.c_void_p(handle))), "feats")
            return None
        n = int(lib.featsl_num(handle))
        table = lib.featsl_parse_ids(ctypes.c_void_p(handle),
                                     ctypes.c_int32(knum))
        bad = int(lib.idt_bad_row(ctypes.c_void_p(table)))
        if bad >= 0:
            from icl_torch.util.log import LOG
            LOG.warning("%s: native fast-path load demoted to the pure-"
                        "Python parser (example #%d's id does not match "
                        "the strict §6.1 %s grammar) — results are "
                        "identical but the load is ~4x slower; run "
                        "`icl-torch-check` to locate such ids", path, bad + 1,
                        kind)
            return None
        _warn_skipped(path, int(lib.featsl_num_skipped(handle)))
        labels = np.empty(max(n, 1), np.float64)
        lib.featsl_fill_labels(
            ctypes.c_void_p(handle),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        ndocs = int(lib.idt_num_docs(ctypes.c_void_p(table)))
        docs_size = int(lib.idt_docs_size(ctypes.c_void_p(table)))
        npad = int(lib.idt_num_padded(ctypes.c_void_p(table)))
        pad_size = int(lib.idt_padded_ids_size(ctypes.c_void_p(table)))
        fields = np.empty((max(n, 1), k), np.int32)
        doc_idx = np.empty(max(n, 1), np.int32)
        padded_rows = np.empty(max(npad, 1), np.int64)
        padded_buf = ctypes.create_string_buffer(max(pad_size, 1))
        docs_buf = ctypes.create_string_buffer(max(docs_size, 1))
        lib.idt_fill(
            ctypes.c_void_p(table),
            fields.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            doc_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            padded_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            padded_buf, docs_buf)
    finally:
        if table:
            lib.idt_free(ctypes.c_void_p(table))
        lib.featsl_free(ctypes.c_void_p(handle))
    docs = (docs_buf.raw[:docs_size].decode("utf-8").split("\0")[:ndocs]
            if ndocs else [])
    overrides: dict[int, str] = {}
    if npad:
        pad_ids = padded_buf.raw[:pad_size].decode("utf-8").split("\0")
        overrides = {int(r): s for r, s in zip(padded_rows[:npad], pad_ids)}
    return labels[:n], fields[:n], doc_idx[:n], docs, overrides


def write_scores_native(path: str, ids: list[str], probs: np.ndarray,
                        chunk: int = 200_000) -> bool:
    """C++ fast path for .scores; returns False if native is unavailable.

    Rows stream in ``chunk``-sized pieces (scores_write_chunk appends
    after the first) so an MSCOCO-scale write never materializes millions
    of encoded id pointers at once — ~0.4 GB of transient peak RSS at
    2.3M rows before this."""
    lib = _load()
    if lib is None:
        return False
    probs = np.ascontiguousarray(probs, dtype=np.float64)
    n, c = probs.shape
    for s in range(0, max(n, 1), chunk):
        part = ids[s:s + chunk]
        arr = (ctypes.c_char_p * len(part))(*[i.encode() for i in part])
        rc = lib.scores_write_chunk(
            path.encode(), arr,
            probs[s:s + chunk].ctypes.data_as(
                ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(len(part)), ctypes.c_int32(c),
            ctypes.c_int32(1 if s else 0))
        if rc != 0:
            return False
    return True
