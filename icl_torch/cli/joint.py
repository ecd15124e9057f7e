"""icl-torch-joint — joint relation + grounding inference over one split
(counterpart of ``icl/cli/joint.py``).

The joint ILP itself lives on the Java side; this entry point produces, in
one invocation, every `.scores` file that solver consumes: nonvisual,
relation, affinity (and cardinality with ``--with_cardinality``, the box
ranking with ``--with_rank``), by calling each task's own ``main`` with the
shared flags.  Inference only.  On the GPU the relation and affinity
sub-runs go through the hand-written kernels (grid head, LSTM recurrence,
and the box ranking with ``--with_rank``); the mention sub-runs launch none.

The multi-process flags (``--mesh``, ``--coordinator``, ``--num_processes``,
``--process_id``) are forwarded to every sub-run, so each runs its sharded
predict: the first brings up the process group, the rest reuse it
(:func:`icl_torch.runtime.init` is idempotent per topology).
``--matmul_precision``, ``--compute_dtype`` and the oracle flags
(``--oracle-parity``, ``--oracle-parity-full``) go to every sub-run too.
"""

from __future__ import annotations

import os

from icl_torch.cli import affinity as aff_cli
from icl_torch.cli import cardinality as card_cli
from icl_torch.cli import nonvisual as nv_cli
from icl_torch.cli import relation as rel_cli
from icl_torch.cli._common import base_parser, check_flags
from icl_torch.util.log import LOG


def main(argv=None) -> None:
    p = base_parser("joint", "Run nonvisual + relation + affinity predict "
                             "over one split (the full Java-ILP input set).")
    p.add_argument("--images_per_batch", type=int, default=8)
    # no --head_hidden here: per-task model_config.json is authoritative on
    # predict, so exposing the flag would only mislead
    p.add_argument("--with_cardinality", action="store_true")
    p.add_argument("--with_rank", action="store_true",
                   help="also write <split>.affinity.rank (per-image box-"
                        "ranking distributions)")
    p.add_argument("--fused", default="auto", choices=["auto", "on", "off"],
                   help="the hand-written kernels of the relation and "
                        "affinity sub-runs (auto: on when the device is "
                        "CUDA)")
    args = p.parse_args(argv)
    if args.train:
        p.error("icl-torch-joint is inference-only; train per-task CLIs "
                "instead")
    # flags that can't mean one thing across the sub-runs, or that this
    # wrapper doesn't implement, HARD-ERROR instead of being ignored
    for flag, val, why in (
            ("--config", args.config, "pass per-task flags instead"),
            ("--model_file", args.model_file,
             "per-task <data_dir>/<task>.model dirs are used"),
            ("--scores_file", args.scores_file,
             "per-task default .scores paths are used"),
            ("--metrics_file", args.metrics_file, "train-only"),
            ("--profile_dir", args.profile_dir,
             "profile the relation or affinity --predict on its own")):
        if val:
            p.error(f"{flag} is not supported by icl-torch-joint ({why})")
    # the oracle flags need Keras: refused here, by name, before any
    # sub-run starts where it cannot be imported (they go to every sub-run,
    # as do --compute_dtype and --matmul_precision)
    check_flags(args)

    common = ["--predict", "--data_dir", args.data_dir,
              "--data_split", args.data_split,
              "--lstm_hidden_width", str(args.lstm_hidden_width),
              "--seed", str(args.seed),
              "--compute_dtype", args.compute_dtype,
              "--batch_size", str(args.batch_size),
              "--dropout", str(args.dropout),
              "--device", args.device]
    if args.mesh:
        common += ["--mesh", args.mesh]
    # multi-process sweep: forward the bootstrap flags so every sub-CLI runs
    # its sharded predict.  Dropping them would make every process sweep the
    # FULL split and race on the same .scores paths.
    if args.coordinator:
        common += ["--coordinator", args.coordinator]
    if args.num_processes is not None:
        common += ["--num_processes", str(args.num_processes)]
    if args.process_id is not None:
        common += ["--process_id", str(args.process_id)]
    if args.matmul_precision:
        common += ["--matmul_precision", args.matmul_precision]
    if args.compilation_cache_dir:
        common += ["--compilation_cache_dir", args.compilation_cache_dir]
    if args.hidden_width:
        common += ["--hidden_width", str(args.hidden_width)]
    if args.embeddings_file:
        common += ["--embeddings_file", args.embeddings_file]
    if not args.prune_embeddings:
        common += ["--no_prune_embeddings"]
    if args.eval:
        common += ["--eval"]
    if args.oracle_parity:
        common += ["--oracle-parity"]
    if args.oracle_parity_full:
        common += ["--oracle-parity-full"]

    # NOTE: no per-task width forwarding — each sub-CLI reads its own
    # <task>.model/model_config.json on predict and that wins over flags
    LOG.info("joint inference over %s/%s", args.data_dir, args.data_split)
    image = ["--images_per_batch", str(args.images_per_batch),
             "--fused", args.fused]
    nv_cli.main(list(common))
    rel_cli.main(common + image)
    aff_cli.main(common + image
                 + (["--rank_file", os.path.join(
                        args.data_dir, f"{args.data_split}.affinity.rank")]
                    if args.with_rank else []))
    if args.with_cardinality:
        card_cli.main(list(common))
    LOG.info("joint inference complete: all .scores written for %s",
             args.data_split)


if __name__ == "__main__":
    main()
