"""icl-torch-affinity — phrase-box affinity scorer CLI (counterpart of
``icl/cli/affinity.py``).

`.scores` per (mention, box) cell with class order [no_affinity, affinity];
``--rank_file`` also writes each cell's share of the per-image softmax over
the candidate boxes of its mention.  Runs on the GPU unless ``--device cpu``
is given.  With ``--fused`` on (``auto`` on CUDA) the model runs the
hand-written kernels: the grid head at predict, the fused-CE training grid
head in ``--train`` (always the grid loss) and in the dev eval, the LSTM
recurrence throughout, and for ``--rank_file`` the box-ranking kernel
(:func:`icl_torch.ops.affinity_rank.affinity_rank`, through
:func:`icl_torch.train.steps.affinity_predict`); the reference CLI ranks
with plain array code (``rank_boxes``), which is what an unfused model runs
here.  Under ``--compute_dtype bf16`` the table, the phrase encoder and the
box features' copy to the device are bf16, and the predict, the dev eval
and the ranking take the kernels' bf16 fast-dot modes (rank and
probabilities from one set of logits, as in the reference).
``--matmul_precision`` sets cuBLAS's f32 mode and the training kernels'
precision as in ``icl-torch-relation``.

The model dir holds what ``icl-torch-relation``'s does, with
``affinity.npz`` as the archive's name.  The multi-process flags do what
they do there; a sharded ``--predict`` balances the ranks by cell counts and
merges the ``--rank_file`` as it merges the ``.scores``.
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
from icl_torch.data.imagebatch import AffinityBatcher
from icl_torch.data.pipeline import load_affinity_dataset
from icl_torch.dist.mesh import is_main_process, local_data_rows
from icl_torch.io.captions import parse_mention_id
from icl_torch.io.scores import write_scores_sharded
from icl_torch.models.affinity import AFFINITY_CLASSES, AffinityModel
from icl_torch.train.evalhook import build_eval_hook
from icl_torch.train.loop import profile_trace, run_training
from icl_torch.train.state import create_train_state
from icl_torch.train.steps import affinity_predict, make_affinity_train_step
from icl_torch.util import trace
from icl_torch.util.log import LOG


def predict_parts(model, table, ds, batcher, rank: bool):
    """The ``--predict`` sweep of a loaded model over a split, its word
    vectors on the model's device: the batches, the predict function (the
    box ranking in a last column with ``rank``), where each cell's row lies
    in its output, and the cell ids in dataset order."""
    # dataset order: per image, mention-major over the valid cells
    order = []
    for im in ds.images:
        for r, mid in enumerate(im.mention_ids):
            _, ci, mi = parse_mention_id(mid)
            for c, bi in enumerate(im.box_idx):
                if im.grid_valid[r, c]:
                    order.append(im.cell_id(ci, mi, bi))

    def predict(jb):
        """ONE host fetch per batch: softmax probs and (when ranking) the
        per-image box-ranking distribution ride in a single
        [I, M*B, 2(+1)] tensor."""
        if not rank:
            return affinity_predict(model, table, jb).flatten(1, 2)
        probs, ranking = affinity_predict(model, table, jb, rank=True)
        return torch.cat([probs, ranking[..., None]], dim=-1).flatten(1, 2)

    return batcher.batches(ds), predict, image_rows, order


def write_rank(path: str, split: str, order, ranks, total: int,
               fused: bool) -> None:
    """``--rank_file``: each cell's share of its mention's softmax over the
    image's boxes (merged on process 0 in a sharded run)."""
    with trace.span("scores.write", task="affinity_rank", rows=len(order)):
        write_scores_sharded(
            path, order, ranks, num_classes=1, total_examples=total,
            class_order=["rank_prob"],
            meta={"task": "affinity_rank", "split": split,
                  "ranked_by": ("box-ranking kernel" if fused else
                                "rank_boxes"),
                  "note": "per-image softmax over candidate boxes "
                          "per mention"})
    LOG.info("wrote %d rank probs to %s", len(order), path)


def main(argv=None) -> None:
    p = base_parser(
        "affinity",
        "Phrase-box affinity scorer: LSTM phrase embeddings x VGG fc7 box "
        "features, batched GEMM + per-image softmax.")
    p.add_argument("--images_per_batch", type=int, default=64,
                   help="images per device batch (small datasets round "
                        "down fine via padding)")
    p.add_argument("--head_hidden", type=int, default=1024)
    p.add_argument("--fused", default="auto",
                   choices=["auto", "on", "off"],
                   help="the hand-written kernels (auto: on when the "
                        "device is CUDA)")
    p.add_argument("--rank_file", default=None,
                   help="with --predict: also write per-image box-ranking "
                        "distributions (softmax over candidate boxes per "
                        "mention) to this path")
    p.add_argument("--phrase_enc", default="lstm",
                   choices=["lstm", "mean_w2v"])
    args = parse_task_args(p, argv, "affinity")
    rt = init_runtime(args)
    device = rt.device
    prec = apply_precision(args, device)
    cd = resolve_compute_dtype(args)
    emb = load_embeddings(args)
    # the frozen word-vector table lies on the device in the compute dtype
    table = torch.from_numpy(emb.table).to(device, cd)
    ds = load_affinity_dataset(args.data_dir, args.data_split, emb)
    LOG.info("affinity %s: %d images, %d cells", args.data_split,
             len(ds.images), ds.num_cells)

    ipb = round_to_data_axis(args.images_per_batch, rt, bool(args.predict),
                             "images_per_batch")
    batcher = AffinityBatcher(
        images_per_batch=ipb,
        mention_spec=bucket_spec(args, "mentions_per_image", (8, 16, 32)),
        box_spec=bucket_spec(args, "boxes_per_image", (8, 16, 32)),
        box_dtype=cd, with_ids=not args.train)
    model_dir = default_model_dir(args, "affinity")
    lstm_hidden, head_hidden = args.lstm_hidden_width, args.head_hidden
    phrase_enc = args.phrase_enc
    if args.predict:
        mc = read_model_config(model_dir, "affinity")
        lstm_hidden = mc.get("lstm_hidden", lstm_hidden)
        head_hidden = mc.get("head_hidden", head_hidden)
        phrase_enc = mc.get("phrase_enc", phrase_enc)
    fused = use_fused(args, device)
    model = AffinityModel(emb_dim=emb.dim, box_dim=ds.box_dim,
                          lstm_hidden=lstm_hidden, head_hidden=head_hidden,
                          num_classes=len(AFFINITY_CLASSES),
                          phrase_enc=phrase_enc, fused=fused,
                          dropout=args.dropout, device=device,
                          compute_dtype=cd, exact=prec.head_exact)
    archive = weights_archive(model_dir, "affinity")
    state = create_train_state(model, seed=args.seed,
                               learn_rate=args.learn_rate, params=archive)
    if archive:
        LOG.info("weights from %s", archive)

    if args.train:
        step = make_affinity_train_step(grid_loss=model.fused, mesh=rt.mesh)
        # input sharding: this rank builds only the rows it feeds, 4096-d
        # box features included (see icl_torch/cli/relation.py)
        rows = local_data_rows(rt.mesh, ipb)

        def make_batches(epoch_rng, skip=0):
            for b in batcher.batches(ds, rng=epoch_rng, skip=skip,
                                     host_rows=rows):
                yield (to_device(b.arrays, device),)

        eval_fn = build_eval_hook(
            args, model, table,
            lambda d, sp: load_affinity_dataset(d, sp, emb),
            batcher, mesh=rt.mesh)
        if is_main_process():
            dump_run_config(args, model_dir, rt, prec)
        state = run_training(state, lambda s, b: step(s, table, b),
                             make_batches, loop_config(args, model_dir, rt),
                             eval_fn=eval_fn)
        finish_training(state, model_dir,
                        {"task": "affinity",
                         "lstm_hidden": args.lstm_hidden_width,
                         "head_hidden": args.head_hidden,
                         "dropout": args.dropout,
                         "phrase_enc": args.phrase_enc,
                         "compute_dtype": args.compute_dtype,
                         "box_dim": ds.box_dim})
        return

    restore_for_predict(state, model_dir, "affinity")
    model.eval()
    # multi-process: this rank sweeps images[lo:hi); see relation.py
    total_cells = ds.num_cells
    lo, hi = begin_predict(rt, len(ds.images),
                           weights=[int(im.grid_valid.sum())
                                    for im in ds.images])
    if (lo, hi) != (0, len(ds.images)):
        ds = dataclasses.replace(ds, images=ds.images[lo:hi])
    batches, predict, where, order = predict_parts(
        model, table, ds, batcher, bool(args.rank_file))
    with profile_trace(args.profile_dir):
        out = predict_in_order(batches, device, predict, where, order,
                               "cells",
                               len(AFFINITY_CLASSES) + bool(args.rank_file),
                               "affinity")
    if args.oracle_parity or args.oracle_parity_full:
        from icl_torch.eval.oracle import oracle_affinity
        from icl_torch.params import to_numpy

        params = to_numpy(model.flat_params())
        oracle_parity(
            args, batcher.batches(ds),
            lambda b: affinity_predict(model, table,
                                       to_device(b.arrays, device)),
            lambda arrays: oracle_affinity(params, emb.table, arrays,
                                           phrase_enc=phrase_enc),
            "grid_valid")
    probs, ranks = out[:, :2], out[:, 2:]
    scores_path = write_scores(args, "affinity", AFFINITY_CLASSES, order,
                               probs, total_cells, state.step)
    if args.rank_file:
        write_rank(args.rank_file, args.data_split, order, ranks,
                   total_cells, model.fused)
    if args.eval:
        gold = [g for im in ds.images for g in im.grid_label[im.grid_valid]]
        print_eval(AFFINITY_CLASSES, gold, probs, scores_path)


if __name__ == "__main__":
    main()
