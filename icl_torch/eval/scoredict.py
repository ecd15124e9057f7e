"""ScoreDict — per-label precision/recall/F1 accumulator.

The port's copy of ``icl/eval/scoredict.py`` (``merge_sharded`` over
``torch.distributed``); ``tests/test_torch_data.py`` holds it to the original.

Reference parity: SURVEY.md §3.1 C10 — mirrors the reference's
``utils/ScoreDict.py``, itself a port of the Java ``ScoreDict``, which
accumulated (gold, pred) label pairs and printed a per-label P/R/F1 table.
The table format below is pinned so downstream eval diffs are stable
(reference checkout empty; format is a SURVEY.md §0 DECISION).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Hashable, Iterable, Sequence


class ScoreDict:
    """Accumulates gold/pred label pairs; reports per-label P/R/F1 + accuracy."""

    def __init__(self, labels: Sequence[Hashable] | None = None):
        self._gold_counts: dict[Hashable, int] = defaultdict(int)
        self._pred_counts: dict[Hashable, int] = defaultdict(int)
        self._correct_counts: dict[Hashable, int] = defaultdict(int)
        self._total = 0
        self._correct = 0
        self._labels = list(labels) if labels is not None else None

    def increment(self, gold: Hashable, pred: Hashable, count: int = 1) -> None:
        self._gold_counts[gold] += count
        self._pred_counts[pred] += count
        self._total += count
        if gold == pred:
            self._correct_counts[gold] += count
            self._correct += count

    def increment_all(self, golds: Iterable[Hashable], preds: Iterable[Hashable]) -> None:
        # strict: a silently dropped tail (mismatched lengths) is exactly
        # the bug class this eval layer exists to catch
        for g, p in zip(golds, preds, strict=True):
            self.increment(g, p)

    # -- metrics ---------------------------------------------------------
    def precision(self, label: Hashable) -> float:
        denom = self._pred_counts[label]
        return self._correct_counts[label] / denom if denom else 0.0

    def recall(self, label: Hashable) -> float:
        denom = self._gold_counts[label]
        return self._correct_counts[label] / denom if denom else 0.0

    def f1(self, label: Hashable) -> float:
        p, r = self.precision(label), self.recall(label)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    @property
    def accuracy(self) -> float:
        return self._correct / self._total if self._total else 0.0

    @property
    def labels(self) -> list:
        if self._labels is not None:
            return list(self._labels)
        return sorted(set(self._gold_counts) | set(self._pred_counts), key=str)

    def gold_count(self, label: Hashable) -> int:
        return self._gold_counts[label]

    def macro_f1(self) -> float:
        labels = self.labels
        return sum(self.f1(l) for l in labels) / len(labels) if labels else 0.0

    # -- multi-process merge ----------------------------------------------
    def state_dict(self) -> dict:
        """JSON-able snapshot of the raw counts (pair lists, not dicts —
        JSON objects would stringify non-string labels on round-trip)."""
        return {"gold": [[k, v] for k, v in self._gold_counts.items()],
                "pred": [[k, v] for k, v in self._pred_counts.items()],
                "correct": [[k, v] for k, v in self._correct_counts.items()]}

    def update_state(self, d: dict) -> None:
        """Add another ScoreDict's :meth:`state_dict` counts into this one.

        Confusion counts are purely additive, so merging per-shard tables
        reproduces the global table exactly — the basis of the sharded
        ``--eval`` path (:func:`merge_sharded`).  Labels that arrive as
        JSON lists (tuple labels round-tripped through a part file) are
        re-tupled RECURSIVELY so nested-tuple labels also hash identically
        to the originals (a top-level-only re-tuple would leave an inner
        list, silently splitting counts — r4 advisor finding).
        """
        def key(k):
            return tuple(map(key, k)) if isinstance(k, list) else k

        for k, v in d["gold"]:
            self._gold_counts[key(k)] += v
            self._total += v
        for k, v in d["pred"]:
            self._pred_counts[key(k)] += v
        for k, v in d["correct"]:
            self._correct_counts[key(k)] += v
            self._correct += v

    # -- reporting -------------------------------------------------------
    def table(self) -> str:
        """Pinned P/R/F1 table (percent, 2 decimals), e.g.::

            label        |  P      |  R      |  F1     | gold    (%)
            -------------+---------+---------+---------+------------
            coref        |  81.25% |  77.61% |  79.39% |    134 ( 10.5%)
        """
        lines = []
        header = (f"{'label':<12} | {'P':>7} | {'R':>7} | {'F1':>7} | gold    (%)")
        lines.append(header)
        lines.append("-" * 13 + "+" + "-" * 9 + "+" + "-" * 9 + "+" + "-" * 9 + "+" + "-" * 12)
        for label in self.labels:
            gc = self._gold_counts[label]
            pct = 100.0 * gc / self._total if self._total else 0.0
            lines.append(
                f"{str(label):<12} | {100*self.precision(label):6.2f}% |"
                f" {100*self.recall(label):6.2f}% | {100*self.f1(label):6.2f}% |"
                f" {gc:6d} ({pct:5.1f}%)"
            )
        lines.append(f"Accuracy: {100*self.accuracy:.2f}% ({self._correct}/{self._total})")
        return "\n".join(lines)

    def print_scores(self) -> None:
        print(self.table())


def merge_sharded(sd: ScoreDict, path: str) -> ScoreDict | None:
    """Merge per-process ScoreDicts for a sharded ``--eval`` sweep.

    Single-process: returns ``sd`` unchanged.  Multi-process: every process
    holds the confusion counts of its own example slice; counts are
    additive, so each writes a small JSON part ``<path>.sdpart-<k:05d>``
    next to the (shared-storage, same contract as
    :func:`icl_torch.io.scores.write_scores_sharded`) ``path``, and after a
    barrier process 0 sums them into the GLOBAL table, identical to a
    single-process sweep by construction.  Returns the merged ScoreDict on
    process 0 and ``None`` elsewhere (only one process should print).
    """
    import json

    from icl_torch.dist.mesh import gather_parts, process_count

    if process_count() == 1:
        return sd

    def _write(part_path):
        with open(part_path, "w", encoding="utf-8") as f:
            json.dump(sd.state_dict(), f)

    def _merge(part_paths):
        merged = ScoreDict(labels=sd._labels)
        for pp in part_paths:
            with open(pp, encoding="utf-8") as f:
                merged.update_state(json.load(f))
        return merged

    return gather_parts(path, "sdpart", _write, _merge)
