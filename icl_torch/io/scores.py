""".scores writer/reader: the output format the downstream ILP reads.

The port's copy of ``icl/io/scores.py`` (the rows go through the port's
C++ writer where it is built; the multi-process merge runs over
``torch.distributed``); ``tests/test_torch_data.py`` holds it to the original
byte for byte.

Reference parity: SURVEY.md §6.2 (frozen contract).  One line per example::

    <example_id>,<p_0>,<p_1>[,<p_2>,<p_3>]

comma-separated natural probabilities in fixed class order (class orders are
pinned per task in SURVEY.md §6.3–6.5), 6 decimal places.  A sibling
``<path>.meta.json`` records class order / model hash / git sha — additive,
so a Java reader that consumes only the first file is unaffected.

Determinism contract (SURVEY.md §7.3): two runs of this pipeline with the same
seed/config must produce bitwise-identical `.scores` bytes; formatting here is
the last link in that chain, hence the explicit ``%.6f`` and ``\n`` pins.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Sequence

import numpy as np


def write_scores(
    path: str,
    ids: Sequence[str],
    probs: np.ndarray,
    class_order: Sequence[str] | None = None,
    meta: dict | None = None,
) -> None:
    """Write probabilities in the §6.2 byte format (+ sibling meta json).

    Args:
      path: output `.scores` path.
      ids: example ids, length N.
      probs: float array [N, C] of natural probabilities.
      class_order: class names in column order, recorded in the meta file.
      meta: extra metadata merged into the meta file.
    """
    probs = np.asarray(probs, dtype=np.float64)
    if probs.ndim != 2 or probs.shape[0] != len(ids):
        raise ValueError(f"probs shape {probs.shape} does not match {len(ids)} ids")
    _write_rows(path, ids, probs)
    _write_meta(path, len(ids), int(probs.shape[1]), class_order, meta)


def _write_rows(path: str, ids: Sequence[str], probs: np.ndarray) -> None:
    """The §6.2 row bytes only (no meta sidecar), shared by both writers so
    part files go through the identical formatting chain: the C++ writer
    when the native library is available (byte-identical to the Python
    loop; tests/test_torch_native.py), else the loop."""
    from icl_torch.native.feats import write_scores_native

    if write_scores_native(path, list(ids), probs):
        return
    with open(path, "w", encoding="utf-8", newline="\n") as f:
        for eid, row in zip(ids, probs):
            f.write(eid + "," + ",".join(f"{p:.6f}" for p in row) + "\n")


def _write_meta(path: str, n: int, c: int,
                class_order: Sequence[str] | None, meta: dict | None) -> None:
    info = {"num_examples": n, "num_classes": c}
    if class_order is not None:
        info["class_order"] = list(class_order)
    if meta:
        info.update(meta)
    try:
        # provenance = the CODE repo that wrote the scores, so resolve git
        # from this module's location — the output path may live inside a
        # separately-versioned data mount whose HEAD is meaningless here
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)), timeout=5,
        ).stdout.strip()
        if sha:
            info["git_sha"] = sha
    except Exception:
        pass
    with open(path + ".meta.json", "w", encoding="utf-8") as f:
        json.dump(info, f, indent=2, sort_keys=True)
        f.write("\n")


def write_scores_sharded(
    path: str,
    local_ids: Sequence[str],
    local_probs: np.ndarray,
    num_classes: int,
    total_examples: int,
    class_order: Sequence[str] | None = None,
    meta: dict | None = None,
) -> None:
    """Multi-process `.scores` write.

    Each process holds the probabilities for its own *contiguous* slice of
    the dataset order (:func:`icl_torch.dist.mesh.predict_partition`) and
    writes them to ``<path>.part-<k:05d>`` through the same formatting chain
    as :func:`write_scores`; after a barrier, process 0 concatenates the
    parts in process order, a byte-exact concatenation: given the same
    probability arrays, the merged file is byte-identical to a
    single-process write.  Process 0 then writes the meta sidecar with the
    GLOBAL example count, and a second barrier lets every process delete
    its own part file (:func:`icl_torch.dist.mesh.gather_parts`).

    ``path`` must live on storage visible to every process (the same
    contract the checkpoint directory carries); without it, process 0's
    merge fails loudly with the missing part path.

    Single-process calls degrade to :func:`write_scores` with an explicit
    class count (an empty sweep still records ``num_classes``) and example
    total.
    """
    probs = np.asarray(local_probs, dtype=np.float64)
    if probs.size == 0:
        probs = probs.reshape(0, num_classes)   # an empty slice
    if probs.ndim != 2 or probs.shape[0] != len(local_ids) \
            or probs.shape[1] != num_classes:
        raise ValueError(f"probs shape {probs.shape} does not match "
                         f"{len(local_ids)} ids x {num_classes} classes")
    from icl_torch.dist.mesh import gather_parts, process_count

    if process_count() == 1:
        _write_rows(path, local_ids, probs)
        _write_meta(path, total_examples, num_classes, class_order, meta)
        return

    def _merge(part_paths):
        import shutil

        with open(path, "wb") as out:
            for pp in part_paths:
                with open(pp, "rb") as f:
                    shutil.copyfileobj(f, out)
        _write_meta(path, total_examples, num_classes, class_order, meta)

    gather_parts(path, "part",
                 lambda pp: _write_rows(pp, local_ids, probs), _merge)


def read_scores(path: str) -> tuple[list[str], np.ndarray]:
    """Read a `.scores` file back into (ids, float64[N,C]).

    Ids may themselves contain commas only if they do not parse as floats;
    the §6.1 id schemes (``doc:...;caption:...;mention:...``) are comma-free,
    so the first field is always the id.
    """
    ids: list[str] = []
    rows: list[list[str]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            eid, sep, rest = line.partition(",")
            ids.append(eid)
            # when a separator was present, split unconditionally: a line
            # "id," is one EMPTY field and must fail float('') like the
            # original per-field loop did, not silently become a zero-field
            # row (ADVICE r3)
            rows.append(rest.split(",") if sep else [])
    try:
        # numpy parses the string fields directly (same strtod grammar as
        # %.6f round-trips need) — ~3x faster than per-field float() at
        # MSCOCO scale (2.3M rows)
        return ids, np.asarray(rows, dtype=np.float64)
    except ValueError:
        # ragged rows or Python-only numeric grammar: the float() loop
        # reproduces the original per-field behavior/errors
        return ids, np.asarray([[float(p) for p in r] for r in rows],
                               dtype=np.float64)
