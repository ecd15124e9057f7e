"""icl-torch-eval — score a `.scores` file against gold `.feats` labels
(the port's own copy of ``icl/cli/evaluate.py``; numpy only, same stdout).

ScoreDict as a standalone tool: re-score an existing `.scores` file (e.g.
after thresholding or an ILP round-trip) without re-running a model.  Reads
the `.scores` format and the `.feats` gold labels, joins on the example id,
and prints the pinned ScoreDict table.

Usage::

    icl-torch-eval --task relation --scores dev.relation.scores \
                   --feats dev.relation.feats
    icl-torch-eval --task grounding --scores dev.affinity.rank \
                   --feats dev.affinity.feats   # top-1 grounding accuracy
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from icl_torch.data.pairs import RELATION_CLASSES
from icl_torch.eval.scoredict import ScoreDict
from icl_torch.io.feats import read_feats_labels
from icl_torch.io.scores import read_scores
from icl_torch.models.affinity import AFFINITY_CLASSES
from icl_torch.models.cardinality import CARDINALITY_CLASSES
from icl_torch.models.nonvisual import NONVIS_CLASSES
from icl_torch.util.log import LOG

# the contract-pinned class orders, imported from their single sources
TASK_CLASSES = {
    "nonvisual": NONVIS_CLASSES,
    "relation": RELATION_CLASSES,
    "affinity": AFFINITY_CLASSES,
    "cardinality": CARDINALITY_CLASSES,
}


def _grounding_accuracy(ids, probs, gold, strict: bool = False) -> None:
    """Top-1 grounding accuracy from a --rank_file output.

    Groups per-(mention, box) ranking scores by mention, takes the
    top-ranked box, and checks the gold affinity label of that cell —
    the metric the reference's grounding pipeline (and its ILP) optimized
    for, computable offline from the two files the pipeline already emits.
    Mentions with no positive gold box are excluded (no groundable target).

    Id-drift hygiene (mirrors the classification join diagnostics): a
    top-ranked cell id absent from gold, or a scored mention with no gold
    cells at all, is reported — warned by default, a hard error under
    ``--strict`` — instead of silently deflating the metric.
    """
    best: dict[str, tuple[float, str]] = {}
    for i, row in zip(ids, probs):
        mention = i.rsplit(";box:", 1)[0]
        score = float(row[0])
        if mention not in best or score > best[mention][0]:
            best[mention] = (score, i)
    has_positive: dict[str, bool] = {}
    for cid, lab in gold.items():
        m = cid.rsplit(";box:", 1)[0]
        has_positive[m] = has_positive.get(m, False) or bool(lab)
    no_gold = [m for m in best if m not in has_positive]
    # gold-groundable mentions the rank file never scored: count them in
    # the denominator as misses — dropping them silently INFLATED the
    # accuracy for truncated rank files (the join is checked in both
    # directions, like the classification branch)
    unscored = [m for m, pos in has_positive.items()
                if pos and m not in best]
    groundable, hits = len(unscored), 0
    unknown_cells: list[str] = []
    for mention, (_, cell_id) in sorted(best.items()):
        if not has_positive.get(mention, False):
            continue                      # nothing groundable: skip
        groundable += 1
        if cell_id in gold:
            hits += gold[cell_id]
        else:
            unknown_cells.append(cell_id)  # counted as a miss, reported
    if no_gold or unknown_cells or unscored:
        example = (unknown_cells or no_gold or unscored)[0]
        msg = (f"{len(no_gold)} scored mentions absent from gold, "
               f"{len(unknown_cells)} top-ranked cells absent from gold "
               f"(scored as misses), {len(unscored)} groundable gold "
               f"mentions never scored (counted as misses); "
               f"e.g. {example!r}")
        if strict:
            raise SystemExit(f"id mismatch: {msg}")
        LOG.warning("id mismatch: %s", msg)
    if groundable == 0:
        raise SystemExit("no groundable mentions in the gold feats")
    sys.stdout.write(
        f"Top-1 grounding accuracy: {hits / groundable * 100:.2f}% "
        f"({hits}/{groundable} groundable mentions)\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        "icl-torch-eval", description="ScoreDict P/R/F1 for a .scores file "
                                "against gold .feats labels (or top-1 "
                                "grounding accuracy for --task grounding)")
    p.add_argument("--task", required=True,
                   choices=sorted(TASK_CLASSES) + ["grounding"])
    p.add_argument("--scores", required=True, help=".scores file")
    p.add_argument("--feats", required=True,
                   help="gold .feats file (labels + ids)")
    p.add_argument("--strict", action="store_true",
                   help="error (instead of warn) when ids in one file are "
                        "missing from the other")
    args = p.parse_args(argv)

    ids, probs = read_scores(args.scores)
    if not ids:
        raise SystemExit(f"{args.scores}: no score lines")
    if args.task == "grounding":
        if probs.shape[1] != 1:
            raise SystemExit(
                f"{args.scores}: grounding expects a --rank_file "
                f"(1 column), got {probs.shape[1]}")
        gids, glabels = read_feats_labels(args.feats)
        gold = {i: int(l) for i, l in zip(gids, glabels)}
        _grounding_accuracy(ids, probs, gold, strict=args.strict)
        return
    classes = TASK_CLASSES[args.task]
    if probs.shape[1] != len(classes):
        raise SystemExit(
            f"{args.scores}: {probs.shape[1]} classes, expected "
            f"{len(classes)} for task {args.task!r}")
    gids, glabels = read_feats_labels(args.feats)
    gold = {i: int(l) for i, l in zip(gids, glabels)}

    missing_gold = [i for i in ids if i not in gold]
    scored = set(ids)
    missing_scores = [i for i in gold if i not in scored]
    if missing_gold or missing_scores:
        msg = (f"{len(missing_gold)} scored ids missing from gold, "
               f"{len(missing_scores)} gold ids missing from scores")
        if args.strict:
            raise SystemExit(f"id mismatch: {msg}")
        LOG.warning("id mismatch (joining on intersection): %s", msg)
    if len(ids) != len(scored):
        # e.g. concatenated shard outputs: each repeat used to increment
        # the confusion matrix again, inflating every denominator
        msg = (f"{len(ids) - len(scored)} duplicate ids in "
               f"{args.scores} — counting the first occurrence only")
        if args.strict:
            raise SystemExit(f"duplicate ids: {msg}")
        LOG.warning("%s", msg)

    sd = ScoreDict(labels=list(classes))
    # vectorized join: argmax once over the whole [N,C] block, then
    # accumulate the confusion counts via bincount instead of 2.3M
    # per-row increment calls (29 -> ~9 s at MSCOCO scale)
    preds = probs.argmax(axis=1)
    C = len(classes)
    codes: list[int] = []
    seen: set[str] = set()
    for k, i in enumerate(ids):
        g = gold.get(i)
        if g is None or i in seen:
            continue
        seen.add(i)
        if not 0 <= g < C:
            raise SystemExit(f"{args.feats}: gold label {g} outside the "
                             f"{C}-class {args.task} range for id {i!r}")
        codes.append(g * C + int(preds[k]))
    if not codes:
        raise SystemExit("no overlapping ids between scores and gold")
    counts = np.bincount(np.asarray(codes, np.int64), minlength=C * C)
    for code in np.flatnonzero(counts):
        g, pr = divmod(int(code), C)
        sd.increment(classes[g], classes[pr], count=int(counts[code]))
    sys.stdout.write(sd.table())   # includes the pinned Accuracy line


if __name__ == "__main__":
    main()
