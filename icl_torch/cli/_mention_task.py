"""Shared body of the mention-level FFNN task CLIs (nonvisual, cardinality);
counterpart of ``icl/cli/_mention_task.py``.

``.feats`` labels and mention token spans -> mean-pool -> FFNN train step
-> ``.scores`` -> ScoreDict.  One bucket (the dataset's padded mention
length), ``--batch_size`` rows a batch.  Runs on the GPU unless ``--device
cpu`` is given.  No hand-written kernel lies on this path.
``--compute_dtype bf16`` is taken and has no effect (one log line says
so): the reference's mention tasks take no compute dtype.
``--matmul_precision`` sets cuBLAS's f32 mode for the FFNN (TF32 under
``default`` on CUDA, the ``--train`` default; full f32 under ``high``, the
``--predict`` default, and ``highest``), as in the image tasks; no kernel
of the training grid head lies on this path.

The model dir (``--model_file``) is laid out as the image tasks' is:
``step_<n>.pt`` checkpoints, ``model_config.json`` (``task``, ``hidden``,
``num_classes``, ``dropout``), ``train_config.json``, and optionally
``<task>.npz`` (+ manifest) from ``icl-export``.  ``--predict`` takes the
newest checkpoint, else the archive, else the initial weights with a
warning; the hidden width comes from ``model_config.json`` (or the
archive's manifest) when there is one.

With ``--coordinator``, ``--num_processes`` and ``--process_id`` the run is
one rank of a data-parallel one (:mod:`icl_torch.cli._common`).  Mention
batches are cheap to assemble, so in ``--train`` every rank builds the
(rng-deterministic, hence identical) global batch and feeds its own row
slice; ``--predict`` sweeps the rank's contiguous slice of the mentions and
rank 0 merges the ``.scores`` parts and the ``--eval`` tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from icl_torch.cli._common import (apply_precision, begin_predict,
                                   default_model_dir, dump_run_config,
                                   finish_training, init_runtime,
                                   load_embeddings, loop_config,
                                   read_model_config, report_parity,
                                   restore_for_predict, round_to_data_axis,
                                   to_device, weights_archive)
from icl_torch.cli._predict import (mention_rows, predict_in_order,
                                    print_eval, write_scores)
from icl_torch.data.buckets import Bucketizer, BucketSpec
from icl_torch.data.pipeline import load_mention_dataset
from icl_torch.dist.mesh import is_main_process, local_data_rows
from icl_torch.train.evalhook import build_mention_eval_hook
from icl_torch.train.loop import run_training
from icl_torch.train.state import create_train_state
from icl_torch.train.steps import make_mention_train_step, mention_predict
from icl_torch.util.log import LOG


def predict_parts(model, table, ds, bz):
    """The ``--predict`` sweep of a loaded model over a split, its word
    vectors on the model's device: the bucketizer's batches (token ids and
    lengths), the predict function, where each mention's row lies in its
    output, and the mention ids in dataset order."""
    arrays = {"token_ids": ds.token_ids, "lengths": ds.lengths}
    return ((b for _, b in bz.batches(ds.lengths, arrays, ds.ids)),
            lambda a: mention_predict(model, table, a["token_ids"],
                                      a["lengths"]),
            mention_rows, ds.ids)


def run(args, task: str, model_cls, classes: tuple[str, ...]) -> None:
    rt = init_runtime(args)
    device = rt.device
    prec = apply_precision(args, device)
    if args.compute_dtype == "bf16":
        LOG.info("--compute_dtype bf16 has no effect on %s: the mention "
                 "tasks run in f32, as the reference's do", task)
    emb = load_embeddings(args)
    table = torch.from_numpy(emb.table).to(device)
    ds = load_mention_dataset(args.data_dir, args.data_split, task, emb)
    LOG.info("%s %s: %d mentions", task, args.data_split, len(ds.ids))

    model_dir = default_model_dir(args, task)
    hidden = args.hidden_width or 300
    if args.predict:
        hidden = read_model_config(model_dir, task).get("hidden", hidden)
    model = model_cls(emb_dim=emb.dim, hidden=hidden, dropout=args.dropout,
                      num_classes=len(classes), device=device)
    archive = weights_archive(model_dir, task)
    state = create_train_state(model, seed=args.seed,
                               learn_rate=args.learn_rate, params=archive)
    if archive:
        LOG.info("weights from %s", archive)

    bs = round_to_data_axis(args.batch_size, rt, bool(args.predict),
                            "batch_size")
    bz = Bucketizer(BucketSpec((ds.max_len,)), batch_size=bs)

    if args.train:
        arrays = {"token_ids": ds.token_ids, "lengths": ds.lengths,
                  "labels": ds.labels}
        step = make_mention_train_step(mesh=rt.mesh)
        lo, hi = local_data_rows(rt.mesh, bs)    # one process: every row

        def make_batches(epoch_rng, skip=0):
            for _, b in bz.batches(ds.lengths, arrays, ds.ids,
                                   shuffle_rng=epoch_rng, skip=skip):
                tup = (b.arrays["token_ids"], b.arrays["lengths"],
                       b.arrays["labels"], b.valid)
                yield to_device(tuple(a[lo:hi] for a in tup), device)

        eval_fn = build_mention_eval_hook(args, model, table, task, emb, bz,
                                          mesh=rt.mesh)
        if is_main_process():
            dump_run_config(args, model_dir, rt, prec)
        state = run_training(state, lambda s, *a: step(s, table, *a),
                             make_batches, loop_config(args, model_dir, rt),
                             eval_fn=eval_fn)
        finish_training(state, model_dir,
                        {"task": task, "hidden": hidden,
                         "num_classes": len(classes),
                         "dropout": args.dropout})
        return

    # --predict
    restore_for_predict(state, model_dir, task)
    model.eval()
    # multi-process: this rank sweeps mentions[lo:hi) on its own device
    total_mentions = len(ds.ids)
    lo, hi = begin_predict(rt, len(ds.ids))
    if (lo, hi) != (0, len(ds.ids)):
        ds = dataclasses.replace(ds, token_ids=ds.token_ids[lo:hi],
                                 lengths=ds.lengths[lo:hi],
                                 labels=ds.labels[lo:hi], ids=ds.ids[lo:hi])
    batches, predict, where, ids = predict_parts(model, table, ds, bz)
    probs = predict_in_order(batches, device, predict, where, ids,
                             "mentions", len(classes), task)
    if args.oracle_parity or args.oracle_parity_full:
        from icl_torch.eval.oracle import oracle_ffnn
        from icl_torch.models.nonvisual import mean_pool_tokens
        from icl_torch.params import to_numpy

        n = len(ds.ids) if args.oracle_parity_full else min(len(ds.ids), 256)
        max_diff = None     # an empty sharded-predict slice: SKIPPED
        if n:
            tok, ln = to_device((ds.token_ids[:n], ds.lengths[:n]), device)
            with torch.inference_mode():
                pooled = mean_pool_tokens(table, tok, ln).cpu().numpy()
            p_oracle = oracle_ffnn(to_numpy(model.flat_params()), pooled)
            max_diff = float(np.abs(probs[:n] - p_oracle).max())
        report_parity(max_diff)
    scores_path = write_scores(args, task, classes, ds.ids, probs,
                               total_mentions, state.step)
    if args.eval:
        print_eval(classes, ds.labels, probs, scores_path)
