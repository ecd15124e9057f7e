"""The ``--predict`` sweep the task CLIs share: the dispatch-ahead loop,
the scatter of each example's row into dataset order, the ``.scores``
write and the ``--eval`` table.

What differs by task stays in the CLI: the batches, the predict function,
where each example's row lies in that function's output and the ids in
dataset order (each CLI's ``predict_parts``, which the benchmark's joint
driver calls too), and the gold labels.

While a profile runs (:mod:`icl_torch.util.trace`), span ``icl.sweep``
covers each :func:`predict_in_order` (attributes ``task``, ``unit``,
``examples``), counter ``predict.<unit>`` adds the examples of each batch
read back, and span ``icl.scores.write`` covers each :func:`write_scores`.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from icl_torch.cli._common import default_scores_path, to_device
from icl_torch.eval.scoredict import ScoreDict, merge_sharded
from icl_torch.io.scores import write_scores_sharded
from icl_torch.train.loop import prefetch
from icl_torch.util import trace
from icl_torch.util.log import LOG

PREFETCH_DEPTH = 4   # batches assembled ahead on the prefetch thread
IN_FLIGHT = 3        # predicts queued on the device before the oldest is read


def image_rows(b):
    """An image batch's examples: their (image slot, item) positions in a
    ``[I, items, C]`` output, and their ids."""
    idx = np.asarray([k[:2] for k in b.id_index], np.int64).reshape(-1, 2)
    return (idx[:, 0], idx[:, 1]), [k[2] for k in b.id_index]


def mention_rows(b):
    """A bucketizer batch's examples: its leading rows, and their ids."""
    return (np.arange(len(b.ids)),), b.ids


def sweep(batches, device, predict, where):
    """Yield ``(batch, ids, rows)`` for each of ``batches``, in their order.

    Batch assembly runs in a prefetch thread, and up to ``IN_FLIGHT``
    predicts stay queued on the device before the oldest result is read to
    the host, so the device-to-host read overlaps the device's work and the
    host's padding instead of serialising with them.  ``predict`` takes the
    batch's arrays on ``device``; ``where(batch)`` gives the leading indices
    of the batch's examples into its output, and their ids; ``rows`` are
    those examples' rows, on the host."""
    pending: collections.deque = collections.deque()
    for b in prefetch(batches, depth=PREFETCH_DEPTH):
        pending.append((b, predict(to_device(b.arrays, device))))
        if len(pending) > IN_FLIGHT:
            yield _read(*pending.popleft(), where)
    while pending:
        yield _read(*pending.popleft(), where)


def _read(b, dev_out, where):
    lead, ids = where(b)
    # one host copy and one fancy-index gather a batch: per-row views would
    # pin every batch's whole output for the whole sweep
    return b, ids, dev_out.cpu().numpy()[lead]


def predict_in_order(batches, device, predict, where, ids, unit: str,
                     width: int, task: str) -> np.ndarray:
    """:func:`sweep` over ``batches``, logged as one "predict sweep" line;
    returns the rows of ``ids`` in that (dataset) order, ``[len(ids),
    width]`` in the output's dtype."""
    pos = {eid: k for k, eid in enumerate(ids)}
    out = None
    t_sweep = time.perf_counter()
    with trace.span("sweep", task=task, unit=unit, examples=len(ids)):
        for _, got, rows in sweep(batches, device, predict, where):
            trace.count("predict." + unit, len(got))
            if out is None:
                out = np.empty((len(ids), width), rows.dtype)
            out[[pos[eid] for eid in got]] = rows
    dt = max(time.perf_counter() - t_sweep, 1e-9)
    LOG.info("predict sweep: %d %s in %.2f s (%.0f %s/s), batch "
             "assembly and host bookkeeping included", len(ids), unit, dt,
             len(ids) / dt, unit)
    if not len(ids):
        return np.zeros((0, width))
    if len(pos) < len(ids):
        # a repeated id reads its last row, as a dict keyed by id would
        out = out[[pos[eid] for eid in ids]]
    return out


def write_scores(args, task: str, classes, ids, probs: np.ndarray,
                 total: int, step: int) -> str:
    """This process's ``.scores`` rows (merged on process 0 in a sharded
    run); returns the file's path."""
    path = default_scores_path(args, task)
    with trace.span("scores.write", task=task, rows=len(ids)):
        write_scores_sharded(path, ids, probs, num_classes=len(classes),
                             total_examples=total, class_order=classes,
                             meta={"task": task, "split": args.data_split,
                                   "checkpoint_step": int(step)})
    LOG.info("wrote %d scores (%d total) to %s", len(ids), total, path)
    return path


def print_eval(classes, gold, probs: np.ndarray, scores_path: str) -> None:
    """``--eval``: the gold labels against the argmax of ``probs``, both in
    dataset order.  In a sharded run each process counts its own slice and
    process 0 alone prints the merged table, the single-process one (the
    counts are additive)."""
    sd = ScoreDict(labels=list(classes))
    sd.increment_all([classes[g] for g in gold],
                     [classes[p] for p in probs.argmax(-1)])
    merged = merge_sharded(sd, scores_path)   # None off process 0
    if merged is not None:
        print(merged.table())
