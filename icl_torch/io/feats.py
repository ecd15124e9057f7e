"""`.feats` sparse feature file reader/writer (component C1).

Reference parity: SURVEY.md §6.1 (frozen contract; the reference checkout was
empty — see SURVEY.md §0).  Format, one example per line::

    <label> <idx>:<val> <idx>:<val> ... # <example_id>

* features are 1-indexed, LibSVM-style, may appear in any order;
* labels may be int or float text;
* blank lines and lines whose first non-space char is ``#`` are skipped;
* the trailing ``# <id>`` comment carries the example id the Java side uses
  (e.g. ``doc:123.jpg;caption:0;mention:2``).

A fast C++ parser (icl_torch.native) is used when available; the
pure-Python path below is the always-available reference implementation and
the two are tested for equality (tests/test_torch_native.py).

The port's own copy of ``icl/io/feats.py``: ``icl_torch`` imports
nothing of the JAX package, and ``tests/test_torch_data.py`` holds the two
copies to the same outputs.  Rationale below is the original's; where it
names XLA or the TPU, read PyTorch and the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Sequence

import numpy as np


@dataclasses.dataclass
class FeatsExample:
    """One parsed `.feats` line: example id, label, sparse feature vector."""

    example_id: str
    label: float
    indices: np.ndarray  # int32, 1-indexed as in the file
    values: np.ndarray   # float32

    def to_dense(self, max_idx: int) -> np.ndarray:
        """Densify to float32[max_idx]; feature i lands at position i-1.

        Indices are 1-based (§6.1 LibSVM form); out-of-range ones — 0,
        negative, or > max_idx — are ignored rather than wrapping to the
        tail via negative indexing (r3 review finding)."""
        out = np.zeros(max_idx, dtype=np.float32)
        keep = (self.indices >= 1) & (self.indices <= max_idx)
        out[self.indices[keep] - 1] = self.values[keep]
        return out


def parse_sparse_line(line: str) -> FeatsExample | None:
    """Parse one `.feats` line; returns None for blank/comment lines."""
    stripped = line.strip()
    if not stripped or stripped.startswith("#"):
        return None
    body, _, comment = stripped.partition("#")
    example_id = comment.strip()
    parts = body.split()
    if "_" in body:
        # Python's numeric grammar accepts '1_0.5' where C strtod stops at
        # the underscore — reject up front so line-keeping cannot differ by
        # whether the native .so built (the C side rejects hex similarly)
        raise ValueError(f"underscore in numeric body: {body!r}")
    label = float(parts[0])
    n = len(parts) - 1
    indices = np.empty(n, dtype=np.int32)
    values = np.empty(n, dtype=np.float32)
    for k, tok in enumerate(parts[1:]):
        idx, _, val = tok.partition(":")
        indices[k] = int(idx)
        values[k] = float(val)
    return FeatsExample(example_id=example_id, label=label, indices=indices, values=values)


def iter_feats(path: str) -> Iterator[FeatsExample]:
    """Stream-parse a `.feats` file.

    A line whose label or any idx:val token fails to parse is dropped
    WHOLE with one warning per file — identical to the native parser
    (icl_native.cpp parse_line), so behavior cannot differ by whether the
    .so built."""
    skipped = 0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            try:
                ex = parse_sparse_line(line)
            except (ValueError, OverflowError):
                # OverflowError: a feature index outside int32 (numpy 2.x
                # raises it, not ValueError) — the native parser drops the
                # same line via its explicit range check
                skipped += 1
                continue
            if ex is not None:
                yield ex
    if skipped:
        from icl_torch.util.log import LOG
        LOG.warning("%s: skipped %d malformed line(s)", path, skipped)


def read_feats(path: str, use_native: bool = True) -> list[FeatsExample]:
    """Read a whole `.feats` file.

    Tries the C++ fast parser first (icl_torch.native.feats) and falls back
    to the pure-Python implementation; results are identical by
    construction and test.
    """
    if use_native:
        from icl_torch.native import feats as _native

        parsed = _native.parse_feats_file(path)
        if parsed is not None:
            return [
                FeatsExample(example_id=eid, label=lbl, indices=idx, values=val)
                for eid, lbl, idx, val in parsed
            ]
    return list(iter_feats(path))


def iter_feats_labels(path: str) -> Iterator[tuple[str, float]]:
    """Stream (example_id, label) pairs without parsing the idx:val columns.

    Pure-Python fallback for :func:`read_feats_labels`; same line semantics
    as the native labels scan (blank/comment skip, `# id` comment, lines
    with an unparseable LABEL dropped whole with one warning per file —
    idx:val tokens are deliberately not validated on this path)."""
    skipped = 0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            body, _, comment = s.partition("#")
            lab_tok = body.split(None, 1)[0]
            try:
                if "_" in lab_tok:     # match the C grammar, see above
                    raise ValueError(lab_tok)
                label = float(lab_tok)
            except ValueError:
                skipped += 1
                continue
            yield comment.strip(), label
    if skipped:
        from icl_torch.util.log import LOG
        LOG.warning("%s: skipped %d malformed line(s)", path, skipped)


def read_feats_labels(path: str, use_native: bool = True
                      ) -> tuple[list[str], np.ndarray]:
    """(ids, float64 labels) for a `.feats` file, features skipped.

    The relation/affinity/mention dataset loaders consume only id+label
    (SURVEY §4.1–4.4 — the sparse columns feed the sklearn baseline alone);
    this path avoids materializing per-row index/value arrays, which is what
    keeps a 50k-image split load bounded (VERDICT r2 missing#2).  Native
    C++ scan when available; equality with the Python path is tested."""
    if use_native:
        from icl_torch.native import feats as _native

        parsed = _native.parse_feats_labels(path)
        if parsed is not None:
            return parsed
    ids: list[str] = []
    labels: list[float] = []
    for eid, lbl in iter_feats_labels(path):
        ids.append(eid)
        labels.append(lbl)
    return ids, np.asarray(labels, np.float64)


def write_feats(path: str, examples: Iterable[FeatsExample]) -> None:
    """Write examples in the exact §6.1 byte format."""
    with open(path, "w", encoding="utf-8") as f:
        for ex in examples:
            label = int(ex.label) if float(ex.label).is_integer() else ex.label
            toks = [str(label)]
            for i, v in zip(ex.indices, ex.values):
                if float(v).is_integer():
                    sv = str(int(v))
                else:
                    # shortest digits that round-trip the float32 value
                    sv = np.format_float_positional(np.float32(v), unique=True, trim="-")
                toks.append(f"{i}:{sv}")
            f.write(" ".join(toks) + f" # {ex.example_id}\n")


def to_dense_matrix(
    examples: Sequence[FeatsExample], max_idx: int | None = None
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Densify a parsed file into (X float32[N,D], y float32[N], ids).

    The reference fed these to sklearn/LibLinear baselines (component C13);
    here it also feeds the CPU baseline path and tests.
    """
    if max_idx is None:
        max_idx = max((int(ex.indices.max()) for ex in examples if ex.indices.size), default=0)
    X = np.zeros((len(examples), max_idx), dtype=np.float32)
    y = np.empty(len(examples), dtype=np.float32)
    ids = []
    for r, ex in enumerate(examples):
        if ex.indices.size:
            # features beyond max_idx (unseen at train time when densifying
            # a prediction split) are ignored, matching LibLinear semantics
            keep = (ex.indices >= 1) & (ex.indices <= max_idx)
            X[r, ex.indices[keep] - 1] = ex.values[keep]
        y[r] = ex.label
        ids.append(ex.example_id)
    return X, y, ids
