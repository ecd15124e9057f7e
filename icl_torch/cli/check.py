"""icl-torch-check — validate a data directory against the frozen file
contracts (the port's own copy of ``icl/cli/check.py``, bound to the port's
``io`` and ``data`` modules; pure Python, same findings and exit codes).

The `.feats`/captions/mentions/boxes formats are what the Java
preprocessing side emits; this linter verifies a data directory BEFORE
training/predicting on it — grammar per file plus the cross-file
referential integrity the loaders assume (feats example ids → mentions →
captions; affinity cells → boxes; span bounds; label ranges).  The summary
line keeps the ``icl-check:`` prefix, so both packages' checks of one
directory print the same text.

Severities: ERROR = a contract violation the loaders would crash on or
mis-train on; WARNING = legal but suspicious (clipped spans, duplicate
ids, non-integer labels); INFO = notable statistics.  Exit code 0 when no
errors (under ``--strict``, warnings also fail), else 1.
"""

from __future__ import annotations

import argparse
import math
import os

from icl_torch.util.log import LOG

# class-count contract per task (cardinality bins 0..11+)
LABEL_CLASSES = {"relation": 4, "nonvisual": 2, "affinity": 2,
                 "cardinality": 12}


class Report:
    def __init__(self) -> None:
        self.errors = 0
        self.warnings = 0

    def error(self, msg: str) -> None:
        self.errors += 1
        print(f"ERROR   {msg}")

    def warn(self, msg: str) -> None:
        self.warnings += 1
        print(f"WARNING {msg}")

    @staticmethod
    def info(msg: str) -> None:
        print(f"info    {msg}")


def _data_lines(path: str) -> int:
    """Lines the parsers treat as data (non-blank, non-comment)."""
    n = 0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            s = line.strip()
            if s and not s.startswith("#"):
                n += 1
    return n


def _check_captions(path: str, rep: Report):
    from icl_torch.io.captions import read_captions

    try:
        caps = read_captions(path)
    except FileNotFoundError:
        rep.error(f"{path}: missing")
        return None
    except ValueError as e:
        rep.error(str(e))
        return None
    dup = _data_lines(path) - len(caps)
    if dup:
        rep.warn(f"{path}: {dup} duplicate caption key(s) — later lines "
                 "overwrite earlier ones")
    empties = sum(1 for c in caps.values() if not c.tokens)
    if empties:
        rep.warn(f"{path}: {empties} caption(s) with zero tokens")
    rep.info(f"{path}: {len(caps)} captions / "
             f"{len({c.img_id for c in caps.values()})} images")
    return caps


def _check_mentions(path: str, caps, rep: Report):
    from icl_torch.io.captions import read_mentions

    try:
        ms = read_mentions(path)
    except FileNotFoundError:
        rep.error(f"{path}: missing")
        return None
    except ValueError as e:
        rep.error(str(e))
        return None
    seen: set[tuple] = set()
    dangling = clipped = dups = 0
    for m in ms:
        key = (m.img_id, m.cap_idx, m.mention_idx)
        if key in seen:
            dups += 1
        seen.add(key)
        cap = None if caps is None else caps.get(m.caption_key)
        if cap is None:
            dangling += 1
        elif m.last >= len(cap.tokens):
            clipped += 1
    if dups:
        rep.warn(f"{path}: {dups} duplicate mention id(s) — loaders keep "
                 "the last occurrence")
    if dangling:
        rep.error(f"{path}: {dangling} mention(s) reference a caption "
                  "absent from captions.txt")
    if clipped:
        rep.warn(f"{path}: {clipped} mention span(s) extend past their "
                 "caption length (loaders clip to the last real token)")
    rep.info(f"{path}: {len(ms)} mentions")
    return {(m.img_id, m.cap_idx, m.mention_idx) for m in ms}


def _check_feats(data_dir: str, split: str, task: str, mention_keys,
                 boxes, rep: Report) -> None:
    from icl_torch.data.pipeline import parse_affinity_id_padded, split_path
    from icl_torch.io.captions import parse_mention_id_padded, parse_pair_id_padded
    from icl_torch.io.feats import read_feats_labels

    path = split_path(data_dir, split, f"{task}.feats")
    if not os.path.exists(path):
        rep.info(f"{path}: absent (task skipped)")
        return
    ids, labels = read_feats_labels(path)
    malformed = _data_lines(path) - len(ids)
    if malformed:
        rep.warn(f"{path}: {malformed} malformed line(s) the parsers drop")
    parser = {"relation": parse_pair_id_padded,
              "affinity": parse_affinity_id_padded}.get(
                  task, parse_mention_id_padded)
    ncls = LABEL_CLASSES[task]
    bad_ids = bad_refs = bad_boxes = padded = 0
    out_of_range = non_integer = non_finite = 0
    first_bad_id = first_bad_ref = None
    seen_ids: set[str] = set()
    dup_ids = 0
    for eid, lbl in zip(ids, labels):
        if eid in seen_ids:
            dup_ids += 1
        seen_ids.add(eid)
        try:
            parts = parser(eid)
        except ValueError:
            bad_ids += 1
            if first_bad_id is None:
                first_bad_id = eid
            continue
        if parts[-1]:
            padded += 1
        refs = []
        if task == "relation":
            img, ci, mi, cj, mj, _ = parts
            refs = [(img, ci, mi), (img, cj, mj)]
        elif task == "affinity":
            img, ci, mi, bi, _ = parts
            refs = [(img, ci, mi)]
            if boxes is not None and bi not in boxes.get(img, ()):
                bad_boxes += 1
        else:
            img, ci, mi, _ = parts
            refs = [(img, ci, mi)]
        if mention_keys is not None:
            for ref in refs:
                if ref not in mention_keys:
                    bad_refs += 1
                    if first_bad_ref is None:
                        first_bad_ref = eid
                    break
        if not math.isfinite(lbl):
            non_finite += 1
        elif lbl != int(lbl):
            non_integer += 1
        elif not 0 <= int(lbl) < ncls:
            out_of_range += 1
    if bad_ids:
        rep.error(f"{path}: {bad_ids} id(s) violate the {task} grammar "
                  f"(first: {first_bad_id!r})")
    if bad_refs:
        rep.error(f"{path}: {bad_refs} id(s) reference a mention absent "
                  f"from mentions.txt (first: {first_bad_ref!r})")
    if bad_boxes:
        rep.error(f"{path}: {bad_boxes} cell(s) reference a box absent "
                  "from boxes")
    if non_finite:
        rep.error(f"{path}: {non_finite} non-finite label(s) — loaders "
                  "raise on these")
    if out_of_range:
        rep.error(f"{path}: {out_of_range} label(s) outside the {ncls}-"
                  f"class {task} range")
    if non_integer:
        rep.warn(f"{path}: {non_integer} non-integer label(s) — loaders "
                 "truncate toward zero")
    if dup_ids:
        rep.warn(f"{path}: {dup_ids} duplicate example id(s)")
    if padded:
        rep.info(f"{path}: {padded} zero-padded id(s) (exact bytes are "
                 "preserved through .scores)")
    # fast-path census: any line the native C++ loader
    # (icl_torch/native) cannot PROVE byte-equivalent to the Python grammar
    # demotes the WHOLE load to the ~4x-slower Python parsers.  Non-ASCII
    # bytes are the trigger class (grammar-violating ids are already errors
    # above, and those demote too) — count them so a user with one stray
    # byte in millions of rows has a route back to the fast path.
    nonascii = 0
    first_na = None
    lineno = 0
    with open(path, "rb") as f:
        for raw in f:   # physical \n-terminated chunks
            # the parsers (C++ and Python alike) use universal newlines, so
            # bare \r terminates a line too — split each chunk on \r so the
            # census line numbers match the demotion warning's file:line
            pieces = raw.split(b"\r")
            if len(pieces) > 1 and pieces[-1] in (b"\n", b""):
                pieces.pop()   # \r\n collapse / trailing \r: one terminator
            for piece in pieces:
                lineno += 1
                if piece and max(piece) >= 0x80:
                    nonascii += 1
                    if first_na is None:
                        first_na = lineno
    if nonascii:
        rep.info(f"{path}: {nonascii} line(s) contain non-ASCII bytes "
                 f"(first: line {first_na}) — such lines can demote the "
                 "whole load from the native fast path to the Python "
                 "parsers (identical results, ~4x slower)")
    rep.info(f"{path}: {len(ids)} examples")


def _check_boxes(data_dir: str, split: str, rep: Report):
    from icl_torch.data.pipeline import split_path
    from icl_torch.io.boxes import parse_box_id, read_box_feats

    path = split_path(data_dir, split, "boxes.npz")
    if not os.path.exists(path):
        path_txt = split_path(data_dir, split, "boxes.txt")
        if not os.path.exists(path_txt):
            rep.info(f"{path}: absent (affinity box checks skipped)")
            return None
        path = path_txt
    try:
        ids, feats = read_box_feats(path, mmap=path.endswith(".npz"))
    except (ValueError, OSError) as e:
        rep.error(f"{path}: {e}")
        return None
    by_img: dict[str, set[int]] = {}
    bad = dup = 0
    first_dup = None
    for bid in ids:
        try:
            img, bi = parse_box_id(bid)
        except ValueError:
            bad += 1
            continue
        seen = by_img.setdefault(img, set())
        if bi in seen:
            dup += 1
            first_dup = first_dup or bid
        seen.add(bi)
    if bad:
        rep.error(f"{path}: {bad} box id(s) violate the box-id grammar")
    if dup:
        # last-wins is the pinned loader semantics (data/pipeline.py),
        # but a duplicated id almost always means an upstream export bug —
        # earlier rows' features are silently unreachable
        rep.warn(f"{path}: {dup} duplicate box id(s) within an image "
                 f"(first: {first_dup}) — the affinity loader keeps the "
                 "LAST occurrence's features")
    rep.info(f"{path}: {len(ids)} boxes / {len(by_img)} images, "
             f"dim {feats.shape[1] if getattr(feats, 'size', 0) else '?'}")
    return by_img


def _check_scores(path: str, task: str | None, rep: Report) -> None:
    """Lint a `.scores` file against its contract: line format with
    6-decimal probabilities, class count per task, probability sanity,
    duplicate ids, meta-sidecar consistency."""
    import json as _json
    import re

    from icl_torch.io.scores import read_scores

    try:
        ids, probs = read_scores(path)
    except FileNotFoundError:
        rep.error(f"{path}: missing")
        return
    except ValueError as e:
        rep.error(f"{path}: {e}")
        return
    ncols = probs.shape[1] if probs.size else 0
    if task and task in LABEL_CLASSES and ncols \
            and ncols != LABEL_CLASSES[task]:
        rep.error(f"{path}: {ncols} probability column(s), but {task} has "
                  f"{LABEL_CLASSES[task]} classes")
    if probs.size:
        bad_range = int(((probs < 0) | (probs > 1)).any(axis=1).sum())
        if bad_range:
            rep.error(f"{path}: {bad_range} row(s) with probabilities "
                      "outside [0, 1]")
        sums = probs.sum(axis=1)
        off = int((abs(sums - 1.0) > 5e-3).sum())
        if off:
            rep.warn(f"{path}: {off} row(s) whose probabilities do not sum "
                     "to 1 (max |sum-1| = %.3g)" % float(abs(sums - 1).max()))
    dups = len(ids) - len(set(ids))
    if dups:
        rep.warn(f"{path}: {dups} duplicate example id(s)")
    # byte-format lint: every probability field is %.6f (a foreign writer
    # with a different precision would break bitwise-diffing workflows)
    prob_re = re.compile(r"\d+\.\d{6}$")
    misformatted = 0
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            for field in line.split(",")[1:]:
                if not prob_re.match(field):
                    misformatted += 1
                    break
    if misformatted:
        rep.warn(f"{path}: {misformatted} line(s) whose probability fields "
                 "are not 6-decimal fixed format")
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        try:
            meta = _json.load(open(meta_path))
        except ValueError as e:
            rep.error(f"{meta_path}: bad json: {e}")
            meta = None
        if meta:
            order = meta.get("class_order")
            if order is not None and ncols and len(order) != ncols:
                rep.error(f"{meta_path}: class_order has {len(order)} "
                          f"entries but the file has {ncols} columns")
    rep.info(f"{path}: {len(ids)} rows × {ncols} classes")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="icl-torch-check",
        description="Validate a data directory against the file contracts "
                    "(grammar + cross-file referential integrity), or a "
                    ".scores file against its format (--scores).",
        allow_abbrev=False)
    p.add_argument("--data_dir", required=False, default=None)
    p.add_argument("--data_split", default="train",
                   choices=["train", "dev", "test"])
    p.add_argument("--task", default="all",
                   choices=["all"] + sorted(LABEL_CLASSES))
    p.add_argument("--strict", action="store_true",
                   help="warnings also fail the check (exit 1)")
    p.add_argument("--scores", default=None,
                   help="lint a .scores file (line format, class count for "
                        "--task, probability sanity, meta sidecar) instead "
                        "of a data directory")
    args = p.parse_args(argv)

    from icl_torch.data.pipeline import split_path

    rep = Report()
    if args.scores:
        _check_scores(args.scores,
                      None if args.task == "all" else args.task, rep)
        failed = rep.errors or (args.strict and rep.warnings)
        print(f"icl-check: {rep.errors} error(s), {rep.warnings} "
              f"warning(s) — {'FAIL' if failed else 'OK'}")
        if failed:
            raise SystemExit(1)
        return
    if not args.data_dir:
        p.error("one of --data_dir or --scores is required")
    caps = _check_captions(
        split_path(args.data_dir, args.data_split, "captions.txt"), rep)
    mention_keys = _check_mentions(
        split_path(args.data_dir, args.data_split, "mentions.txt"),
        caps, rep)
    boxes = _check_boxes(args.data_dir, args.data_split, rep)
    tasks = (sorted(LABEL_CLASSES) if args.task == "all" else [args.task])
    for task in tasks:
        _check_feats(args.data_dir, args.data_split, task, mention_keys,
                     boxes if task == "affinity" else None, rep)

    failed = rep.errors or (args.strict and rep.warnings)
    print(f"icl-check: {rep.errors} error(s), {rep.warnings} warning(s) — "
          f"{'FAIL' if failed else 'OK'}")
    if failed:
        LOG.error("data directory failed validation")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
