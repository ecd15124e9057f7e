"""icl-torch-relation — pairwise mention-relation classifier CLI
(counterpart of ``icl/cli/relation.py``).

Same train/predict surface and `.scores` byte format as the reference,
class order [null, coref, subset_ij, subset_ji].  Runs on the GPU unless
``--device cpu`` is given.  With ``--fused`` on (``auto`` on CUDA) the
model runs the hand-written kernels: the grid head at predict, the
fused-CE training grid head in ``--train`` (the pair form when a class
weight is <= 0) and in the dev eval, and the LSTM recurrence throughout.
Under ``--compute_dtype bf16`` the table and the BiLSTM are bf16 (the
recurrence kernel's bf16 mode), and the predict and the dev eval take the
grid head's bf16 fast-dot mode.  ``--matmul_precision`` (default:
``default`` for ``--train``, ``high`` for ``--predict``) sets cuBLAS's f32
mode and, in ``--train`` on CUDA, the training kernels' precision: exact
f32 under ``highest``, else their one-pass bf16 mode, as the reference's
(:func:`icl_torch.cli._common.precision_policy`).

The model dir (``--model_file``) holds the port's checkpoints
(``step_<n>.pt``), ``model_config.json`` and ``train_config.json``, and may
hold ``relation.npz`` (+ manifest) from ``icl-export``: ``--predict`` takes
the newest checkpoint, else the archive, else predicts from the initial
weights with a warning; ``--train`` starts from the archive when there is
one (and ``--resume auto`` from the newest checkpoint).

With ``--coordinator``, ``--num_processes`` and ``--process_id`` the run is
one rank of a data-parallel one (:mod:`icl_torch.cli._common`): ``--train``
feeds this rank's rows of every batch and writes from rank 0 alone;
``--predict`` sweeps this rank's slice of the images (balanced by their pair
counts) and rank 0 merges the ranks' ``.scores`` parts and ``--eval``
tables.
"""

from __future__ import annotations

import dataclasses

import torch

from icl_torch.cli._common import (apply_precision, base_parser, bucket_spec,
                                   begin_predict, default_model_dir,
                                   dump_run_config, finish_training,
                                   init_runtime, load_embeddings, loop_config,
                                   oracle_parity, parse_task_args,
                                   read_model_config, resolve_compute_dtype,
                                   restore_for_predict, round_to_data_axis,
                                   to_device, use_fused, weights_archive)
from icl_torch.cli._predict import (image_rows, predict_in_order, print_eval,
                                    write_scores)
from icl_torch.data.imagebatch import RelationBatcher
from icl_torch.data.pairs import RELATION_CLASSES
from icl_torch.data.pipeline import load_relation_dataset
from icl_torch.dist.mesh import is_main_process, local_data_rows
from icl_torch.models.relation import RelationModel
from icl_torch.train.evalhook import build_eval_hook
from icl_torch.train.loop import profile_trace, run_training
from icl_torch.train.state import create_train_state
from icl_torch.train.steps import make_relation_train_step, relation_predict
from icl_torch.util.log import LOG


def predict_parts(model, table, ds, batcher):
    """The ``--predict`` sweep of a loaded model over a split, its word
    vectors on the model's device: the batches, the predict function,
    where each pair's row lies in its output, and the pair ids in dataset
    order."""
    order = [pid for im in ds.images for pid in im.pair_ids]
    return (batcher.batches(ds),
            lambda jb: relation_predict(model, table, jb), image_rows, order)


def main(argv=None) -> None:
    p = base_parser(
        "relation",
        "4-way mention-pair relation classifier (null/coref/subset_ij/"
        "subset_ji) with a shared BiLSTM caption encoder.")
    p.add_argument("--images_per_batch", type=int, default=64,
                   help="images per device batch (small datasets round "
                        "down fine via padding)")
    p.add_argument("--null_weight", type=float, default=0.3,
                   help="CE weight of the dominant null class")
    p.add_argument("--head_hidden", type=int, default=800)
    p.add_argument("--fused", default="auto",
                   choices=["auto", "on", "off"],
                   help="the hand-written kernels (auto: on when the "
                        "device is CUDA)")
    args = parse_task_args(p, argv, "relation")
    rt = init_runtime(args)
    device = rt.device
    prec = apply_precision(args, device)
    cd = resolve_compute_dtype(args)
    emb = load_embeddings(args)
    # the frozen word-vector table lies on the device in the compute dtype
    table = torch.from_numpy(emb.table).to(device, cd)
    ds = load_relation_dataset(args.data_dir, args.data_split, emb)
    LOG.info("relation %s: %d images, %d pairs", args.data_split,
             len(ds.images), ds.num_pairs)

    ipb = round_to_data_axis(args.images_per_batch, rt, bool(args.predict),
                             "images_per_batch")
    batcher = RelationBatcher(
        images_per_batch=ipb,
        len_spec=bucket_spec(args, "caption_len", (16, 32, 48)),
        mention_spec=bucket_spec(args, "mentions_per_image", (8, 16, 32)),
        build_grid=bool(args.train), with_ids=not args.train)
    model_dir = default_model_dir(args, "relation")
    lstm_hidden, head_hidden = args.lstm_hidden_width, args.head_hidden
    if args.predict:
        mc = read_model_config(model_dir, "relation")
        lstm_hidden = mc.get("lstm_hidden", lstm_hidden)
        head_hidden = mc.get("head_hidden", head_hidden)
    fused = use_fused(args, device)
    model = RelationModel(emb_dim=emb.dim, lstm_hidden=lstm_hidden,
                          head_hidden=head_hidden,
                          num_classes=len(RELATION_CLASSES), fused=fused,
                          dropout=args.dropout, device=device,
                          compute_dtype=cd, exact=prec.head_exact)
    archive = weights_archive(model_dir, "relation")
    state = create_train_state(model, seed=args.seed,
                               learn_rate=args.learn_rate, params=archive)
    if archive:
        LOG.info("weights from %s", archive)

    if args.train:
        class_weights = [args.null_weight, 1.0, 1.0, 1.0]
        step = make_relation_train_step(class_weights=class_weights,
                                        grid_loss=model.fused, mesh=rt.mesh)
        # input sharding: this rank pads ONLY the rows it feeds; the
        # schedule stays globally agreed (rng-deterministic), so the ranks
        # stay in lockstep.  One process: every row.
        rows = local_data_rows(rt.mesh, ipb)

        def make_batches(epoch_rng, skip=0):
            for b in batcher.batches(ds, rng=epoch_rng, skip=skip,
                                     host_rows=rows):
                yield (to_device(b.arrays, device),)

        # the train batcher already has build_grid=True/with_ids=False and
        # is stateless aside from the per-image pad cache — share it
        eval_fn = build_eval_hook(
            args, model, table,
            lambda d, sp: load_relation_dataset(d, sp, emb),
            batcher, class_weights=class_weights, mesh=rt.mesh)
        if is_main_process():
            dump_run_config(args, model_dir, rt, prec)
        state = run_training(state, lambda s, b: step(s, table, b),
                             make_batches, loop_config(args, model_dir, rt),
                             eval_fn=eval_fn)
        finish_training(state, model_dir,
                        {"task": "relation",
                         "lstm_hidden": args.lstm_hidden_width,
                         "head_hidden": args.head_hidden,
                         "dropout": args.dropout,
                         "compute_dtype": args.compute_dtype})
        return

    restore_for_predict(state, model_dir, "relation")
    model.eval()
    # multi-process: this rank sweeps images[lo:hi) on its own device and
    # the `.scores` shards merge by byte-exact concatenation
    total_pairs = sum(len(im.pair_ids) for im in ds.images)
    lo, hi = begin_predict(rt, len(ds.images),
                           weights=[len(im.pair_ids) for im in ds.images])
    if (lo, hi) != (0, len(ds.images)):
        ds = dataclasses.replace(ds, images=ds.images[lo:hi])
    batches, predict, where, order = predict_parts(model, table, ds, batcher)
    with profile_trace(args.profile_dir):
        probs = predict_in_order(batches, device, predict, where, order,
                                 "pairs", len(RELATION_CLASSES), "relation")
    if args.oracle_parity or args.oracle_parity_full:
        from icl_torch.eval.oracle import oracle_relation
        from icl_torch.params import to_numpy

        params = to_numpy(model.flat_params())
        oracle_parity(
            args, batcher.batches(ds),
            lambda b: relation_predict(model, table,
                                       to_device(b.arrays, device)),
            lambda arrays: oracle_relation(params, emb.table, arrays),
            "pair_valid")
    scores_path = write_scores(args, "relation", RELATION_CLASSES, order,
                               probs, total_pairs, state.step)
    if args.eval:
        print_eval(RELATION_CLASSES,
                   [g for im in ds.images for g in im.pair_label], probs,
                   scores_path)


if __name__ == "__main__":
    main()
