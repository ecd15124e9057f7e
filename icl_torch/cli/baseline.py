"""icl-torch-baseline — log-linear baselines over raw `.feats` (the port's
own copy of ``icl/cli/baseline.py``).

An sklearn LogisticRegression over the raw sparse feature vectors, the
non-neural baseline.  It runs on the CPU (sklearn; imported inside ``main``,
so nothing needs it at import time) and emits the same `.scores` format, so
the Java ILP can consume baseline scores interchangeably.

Usage::

    icl-torch-baseline --task nonvisual --train --data_dir D
    icl-torch-baseline --task relation --predict --data_dir D \
                       --data_split dev
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from icl_torch.data.pairs import RELATION_CLASSES
from icl_torch.eval.scoredict import ScoreDict
from icl_torch.io.feats import read_feats, to_dense_matrix
from icl_torch.io.scores import write_scores
from icl_torch.models.affinity import AFFINITY_CLASSES
from icl_torch.models.cardinality import CARDINALITY_CLASSES
from icl_torch.models.nonvisual import NONVIS_CLASSES
from icl_torch.util.log import LOG

# the canonical class orders — imported from their single
# sources so baseline .scores can never silently diverge from the
# neural .scores the Java ILP consumes interchangeably
TASK_CLASSES = {
    "nonvisual": NONVIS_CLASSES,
    "relation": RELATION_CLASSES,
    "affinity": AFFINITY_CLASSES,
    "cardinality": CARDINALITY_CLASSES,
}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="icl-torch-baseline",
        description="sklearn LogisticRegression over raw .feats features")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--train", action="store_true")
    mode.add_argument("--predict", action="store_true")
    p.add_argument("--task", required=True, choices=sorted(TASK_CLASSES))
    p.add_argument("--data_dir", required=True)
    p.add_argument("--data_split", default="train",
                   choices=["train", "dev", "test"])
    p.add_argument("--model_file", default=None)
    p.add_argument("--scores_file", default=None)
    p.add_argument("--max_iter", type=int, default=200)
    p.add_argument("--c", type=float, default=1.0, help="inverse reg strength")
    p.add_argument("--eval", action="store_true")
    args = p.parse_args(argv)

    classes = TASK_CLASSES[args.task]
    feats_path = os.path.join(args.data_dir,
                              f"{args.data_split}.{args.task}.feats")
    rows = read_feats(feats_path)
    model_file = args.model_file or os.path.join(
        args.data_dir, f"{args.task}.logistic.pkl")

    if args.train:
        from sklearn.linear_model import LogisticRegression

        X, y, ids = to_dense_matrix(rows)
        clf = LogisticRegression(max_iter=args.max_iter, C=args.c)
        clf.fit(X, y.astype(np.int32))
        with open(model_file, "wb") as f:
            pickle.dump({"clf": clf, "max_idx": X.shape[1],
                         "task": args.task}, f)
        LOG.info("trained logistic on %d examples (%d feats) -> %s",
                 len(ids), X.shape[1], model_file)
        return

    with open(model_file, "rb") as f:
        saved = pickle.load(f)
    clf, max_idx = saved["clf"], saved["max_idx"]
    X, y, ids = to_dense_matrix(rows, max_idx=max_idx)
    raw = clf.predict_proba(X)
    # emit full class columns even if training saw a subset of labels;
    # labels outside [0, num_classes) are a data error, not an index to
    # wrap into the wrong column
    probs = np.zeros((len(ids), len(classes)))
    for col, cls in enumerate(clf.classes_):
        if not 0 <= int(cls) < len(classes):
            raise SystemExit(
                f"label {cls!r} in the trained model is outside the "
                f"{len(classes)}-class order for task {args.task!r} — "
                f"check the training .feats labels")
        probs[:, int(cls)] = raw[:, col]
    scores_path = args.scores_file or os.path.join(
        args.data_dir, f"{args.data_split}.{args.task}.logistic.scores")
    write_scores(scores_path, ids, probs, class_order=classes,
                 meta={"task": args.task, "model": "logistic",
                       "split": args.data_split})
    LOG.info("wrote %d scores to %s", len(ids), scores_path)
    if args.eval:
        sd = ScoreDict(labels=list(classes))
        for g, pr in zip(y.astype(int), probs.argmax(-1)):
            if not 0 <= g < len(classes):
                raise SystemExit(f"gold label {g} outside the "
                                 f"{len(classes)}-class order")
            sd.increment(classes[g], classes[int(pr)])
        print(sd.table())


if __name__ == "__main__":
    main()
