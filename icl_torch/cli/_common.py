"""Shared CLI surface of the port (counterpart of ``icl/cli/_common.py``).

One argparse entry per task with the reference's flag names and defaults
kept verbatim, plus ``--device`` (``cuda`` unless the CPU is asked for, as
``icl-torch-serve``).  Every flag of the reference parses here.

``--coordinator host:port --num_processes N --process_id k`` start one rank
of a data-parallel run over ``torch.distributed`` (:func:`init_runtime`,
:mod:`icl_torch.runtime`): one process drives one device, ``--mesh D`` or
``DxM`` lays the N ranks out (default: all on the data axis) and must cover
every rank.  ``--train`` shards each batch's rows over the data axis and
sums the gradients over the ranks; ``--predict`` gives each rank a
contiguous slice of the split and merges the ranks' part files
(:func:`begin_predict`).  A coordinator without ``--process_id`` runs one
process, with a warning.  Only rank 0 writes the model dir, the metrics
file and the merged outputs, so the ranks must share their storage.

``--compute_dtype bf16`` is the reference's throughput mode
(:func:`resolve_compute_dtype`): relation and affinity run their encoders,
the word-vector table and, for affinity, the box features' copy to the
device in bf16, and a fused model's predict the kernels' bf16 modes; the
parameters, gradients, Adam state and checkpoints stay f32, so a model
trained in one dtype predicts in the other.  The mention tasks take the
flag and log that it has no effect, as the reference ignores it there.

``--matmul_precision default|high|highest`` resolves as the reference's
does (``high`` for ``--predict``, else ``default``) and
:func:`apply_precision` applies it on the run's device
(:func:`precision_policy`, the table in PERF.md section 2): on CUDA,
``default`` takes TF32 for cuBLAS and cuDNN f32 products and the one-pass
bf16 mode of the training grid-head kernels (the reference's default
training precision), ``high`` full f32 products and that one-pass mode,
``highest`` full f32 and exact kernels; on the CPU every mode is exact
f32, as XLA:CPU ignores the precision.

``--predict --oracle-parity`` (``--oracle-parity-full``) holds the port's
probabilities to the Keras oracle (:mod:`icl_torch.eval.oracle`, on the
CPU) on the valid cells of the first two batches (every batch), the mention
tasks on the first 256 mentions (all), after the sweep and before the
``.scores`` write, and prints ``oracle-parity PASS|FAIL`` against
:data:`PARITY_GATE` (:func:`report_parity`).  Keras is imported at start-up,
before any data is loaded: where it cannot be, the run is refused with
:class:`RefusedFlagError`, naming Keras and the flag.

``--compilation_cache_dir`` is accepted and logged: PyTorch runs eagerly,
there is no compiled program to cache (the kernels' libraries are kept
under ``icl_torch/_build``).  ``--hidden_width`` and ``--batch_size`` belong
to the mention tasks (nonvisual, cardinality), which read them; relation and
affinity take ``--head_hidden`` and ``--images_per_batch``, and a value
given to them is logged as unused (the reference leaves both unused in
silence).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

from icl_torch.data.buckets import BucketSpec
from icl_torch.data.embeddings import EmbeddingStore
from icl_torch.io.captions import read_captions
from icl_torch.util.log import LOG

IMAGE_TASKS = ("relation", "affinity")    # batch by --images_per_batch
PARITY_GATE = 1e-5            # f32, TF32 off: on the CPU and on the card


class RefusedFlagError(ValueError):
    """A flag asked for something this machine cannot do."""

    def __init__(self, flag: str, why: str):
        super().__init__(f"{flag}: {why}")
        self.flag = flag


def base_parser(task: str, description: str) -> argparse.ArgumentParser:
    # allow_abbrev=False: flags are a frozen contract, and the pre-parse
    # --config scan (_scan_flag) matches literal tokens
    p = argparse.ArgumentParser(prog=f"icl-torch-{task}",
                                description=description, allow_abbrev=False)
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--train", action="store_true",
                      help="train a model on --data_split")
    mode.add_argument("--predict", action="store_true",
                      help="write .scores for --data_split")
    p.add_argument("--data_dir", required=True,
                   help="directory with <split>.captions.txt / .feats / ...")
    p.add_argument("--data_split", default="train",
                   choices=["train", "dev", "test"])
    p.add_argument("--model_file", default=None,
                   help="model directory: checkpoints saved on train; read "
                        "on predict (the newest checkpoint, else a "
                        "<task>.npz weights archive)")
    p.add_argument("--scores_file", default=None,
                   help="output .scores path (predict mode)")
    p.add_argument("--embeddings_file", default=None,
                   help="word2vec file (text or .bin); default "
                        "<data_dir>/embeddings.txt")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--lstm_hidden_width", type=int, default=200)
    p.add_argument("--hidden_width", type=int, default=None,
                   help="FFNN hidden width (the mention tasks' flag; "
                        "relation and affinity take --head_hidden)")
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--learn_rate", type=float, default=1e-3)
    p.add_argument("--mesh", default=None,
                   help="process topology 'D' or 'DxM' (data x model) over "
                        "the --num_processes ranks, one device each; it must "
                        "cover every rank. Default: all ranks on the data "
                        "axis")
    p.add_argument("--profile_dir", default=None,
                   help="profile the training loop (--train) or the "
                        "--predict sweep of relation and affinity: write "
                        "its torch.profiler Chrome trace (trace_<pid>.json) "
                        "and the program's own spans and counters "
                        "(spans_<pid>.jsonl) into this directory")
    p.add_argument("--resume", default="none", choices=["none", "auto"])
    p.add_argument("--ckpt_every", type=int, default=200,
                   help="checkpoint every N steps (0: only at end)")
    p.add_argument("--matmul_precision", default=None,
                   choices=["default", "high", "highest"],
                   help="f32 matrix-product precision; default: 'high' for "
                        "--predict, else 'default'. On CUDA 'default' runs "
                        "cuBLAS/cuDNN in TF32 and the training grid-head "
                        "kernels in one bf16 pass, 'high' full f32 with "
                        "those kernels in one bf16 pass, 'highest' full "
                        "f32 and exact kernels (parity runs); on the CPU "
                        "every mode is exact f32")
    p.add_argument("--eval_every", type=int, default=0,
                   help="train: every N steps, compute the deterministic "
                        "loss/acc over (a capped sample of) --eval_split "
                        "and log it (JSONL eval_* keys). 0: off")
    p.add_argument("--eval_split", default="dev")
    p.add_argument("--eval_batches", type=int, default=16,
                   help="max eval batches per --eval_every hook (held on "
                        "the device for the whole run; the hook logs the "
                        "MB). 0: evaluate the WHOLE eval split, copied to "
                        "the device per eval instead")
    p.add_argument("--early_stop", type=int, default=0,
                   help="stop training once the --eval_every dev loss has "
                        "not improved for N consecutive evals, and restore "
                        "the best state. 0: off; requires --eval_every")
    p.add_argument("--compute_dtype", default="f32",
                   choices=["f32", "bf16"],
                   help="model activation dtype (relation/affinity). bf16 "
                        "is the throughput mode: the encoders, the "
                        "word-vector table and the box features' copy to "
                        "the device run in bf16, and a fused model's "
                        "predict takes the kernels' bf16 modes; its .scores "
                        "exceed the 1e-5 parity gate. Params and "
                        "checkpoints stay f32 either way, so a bf16-trained "
                        "model can predict in f32 and vice versa. No effect "
                        "on the mention tasks")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compilation_cache_dir", default=None,
                   help="accepted for the reference's command lines; "
                        "PyTorch runs eagerly, nothing is cached")
    p.add_argument("--metrics_file", default=None)
    p.add_argument("--config", default=None,
                   help="JSON run config. Keys map to flag dests and become "
                        "defaults (explicit CLI flags still win); 'hosts' "
                        "maps to --coordinator/--num_processes; 'buckets' "
                        "sets the batcher bucket inventory; 'task' must "
                        "match this entry point. Parse via "
                        "parse_task_args()")
    p.add_argument("--coordinator", default=None,
                   help="host:port where rank 0 listens for the "
                        "torch.distributed rendezvous (tcp://host:port); "
                        "without --process_id the run stays one process")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total process count of the data-parallel run")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank in [0, --num_processes); "
                        "giving it starts the multi-process run and needs "
                        "--coordinator and --num_processes")
    p.add_argument("--no_prune_embeddings", dest="prune_embeddings",
                   action="store_false",
                   help="load the full embedding table instead of pruning "
                        "to the split's caption vocabulary")
    p.add_argument("--eval", action="store_true",
                   help="with --predict: print a ScoreDict table vs gold")
    p.add_argument("--oracle-parity", dest="oracle_parity",
                   action="store_true",
                   help="with --predict: compare the first two batches' "
                        "probabilities with the Keras CPU oracle (gate "
                        "1e-5, f32); needs Keras")
    p.add_argument("--oracle-parity-full", dest="oracle_parity_full",
                   action="store_true",
                   help="like --oracle-parity over every batch")
    p.add_argument("--device", default="cuda",
                   help="torch device; the default is the GPU, and the run "
                        "fails without one unless 'cpu' is given")
    return p


# config keys handled structurally rather than as flag defaults
_CONFIG_SPECIAL = ("task", "hosts", "buckets")
_HOSTS_KEYS = ("coordinator", "num_processes")


def _scan_flag(argv, name: str) -> str | None:
    """Pre-parse scan for one ``--flag value`` / ``--flag=value`` in argv."""
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    for i, a in enumerate(argv):
        if a == name and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return None


def parse_task_args(p: argparse.ArgumentParser, argv, task: str):
    """``p.parse_args`` with ``--config <json>`` support.

    The config file's keys become parser *defaults* before the real parse,
    so explicit CLI flags always override config values.  Unknown keys are
    a hard error.  Returns the namespace with an extra ``buckets`` attr
    (dict or None).  Flags this machine cannot honour raise
    :class:`RefusedFlagError` (:func:`check_flags`).
    """
    cfg_path = _scan_flag(argv, "--config")
    buckets = None
    if cfg_path:
        with open(cfg_path) as f:
            cfg = json.load(f)
        if cfg.get("task") not in (None, task):
            p.error(f"--config {cfg_path} is for task {cfg['task']!r}, "
                    f"not {task!r}")
        defaults = {}
        for k, v in cfg.get("hosts", {}).items():
            if k == "note" or k.startswith("_"):
                continue   # documentation keys
            if k not in _HOSTS_KEYS:
                p.error(f"unknown key {k!r} in 'hosts' block of --config "
                        f"{cfg_path} (known: {', '.join(_HOSTS_KEYS)})")
            defaults[k] = v
        buckets = cfg.get("buckets")
        dests = {a.dest for a in p._actions}
        for k, v in cfg.items():
            if k.startswith("_") or k in _CONFIG_SPECIAL:
                continue
            if k not in dests:
                p.error(f"unknown key {k!r} in --config {cfg_path} "
                        f"(no matching flag on icl-torch-{task})")
            defaults[k] = v
        p.set_defaults(**defaults)
    args = p.parse_args(argv)
    args.buckets = buckets
    if getattr(args, "early_stop", 0) and not getattr(args, "eval_every", 0):
        p.error("--early_stop monitors the dev eval — set --eval_every too")
    check_flags(args, task)
    return args


def note_compilation_cache_dir(path: str | None) -> None:
    """``--compilation_cache_dir``, the reference's XLA cache, is taken and
    logged: PyTorch runs eagerly and has nothing to cache."""
    if path:
        LOG.info("--compilation_cache_dir %s: nothing to cache, PyTorch "
                 "runs eagerly (the kernels' libraries are kept under "
                 "icl_torch/_build)", path)


def check_flags(args, task: str | None = None) -> None:
    """Raise :class:`RefusedFlagError` for a flag this machine cannot
    honour (:func:`require_oracle`); log the flags that have no effect in
    ``task``'s entry point (the mention tasks read ``--hidden_width`` and
    ``--batch_size``; the image tasks do not)."""
    require_oracle(args)
    note_compilation_cache_dir(args.compilation_cache_dir)
    if task not in IMAGE_TASKS:
        return
    if args.hidden_width is not None:
        LOG.warning("--hidden_width %d is the FFNN tasks' flag and is unused "
                    "here; this task's head takes --head_hidden",
                    args.hidden_width)
    if args.batch_size != 512:
        LOG.warning("--batch_size %d is the mention tasks' flag and is unused "
                    "here; this task batches by --images_per_batch",
                    args.batch_size)


def require_oracle(args) -> None:
    """``--predict`` with ``--oracle-parity`` (``-full``) imports Keras now,
    at start-up: where it cannot be imported the run is refused before it
    loads any data, not after its sweep.  Without ``--predict`` the flags
    do nothing, as in the reference."""
    flag = ("--oracle-parity-full" if args.oracle_parity_full else
            "--oracle-parity" if args.oracle_parity else None)
    if flag is None or not getattr(args, "predict", False):
        return
    from icl_torch.eval import oracle

    try:
        oracle._k()
    except ImportError as e:
        raise RefusedFlagError(flag, f"the oracle runs the model's layers "
                               f"through Keras, which cannot be imported "
                               f"here ({e}); install Keras 3 (torch "
                               f"backend) or drop {flag}") from e


def init_runtime(args):
    """``runtime.init`` from the parsed flags: the process group when
    ``--process_id`` is given, this rank's device (``--device``; raises
    when the GPU is asked for, the default, and there is none: nothing
    falls back to the CPU), the mesh."""
    from icl_torch import runtime

    return runtime.init(args.mesh, seed=args.seed,
                        coordinator=args.coordinator,
                        num_processes=args.num_processes,
                        process_id=args.process_id, device=args.device)


def round_to_data_axis(rows: int, rt, predict: bool, what: str) -> int:
    """``--images_per_batch`` / ``--batch_size`` rounded up to a multiple of
    the data axis this run's batches shard over, with a warning."""
    from icl_torch.dist.mesh import sweep_data_axis_size

    ndev = sweep_data_axis_size(rt.mesh, predict)
    if rows % ndev:
        rows = ((rows + ndev - 1) // ndev) * ndev
        LOG.warning("%s rounded to %d for %d devices", what, rows, ndev)
    return rows


def begin_predict(rt, n_examples: int, weights=None) -> tuple[int, int]:
    """Set up the (possibly multi-process) predict sweep: the ``[lo, hi)``
    slice of the dataset's examples this process sweeps.

    Single-process: ``(0, n_examples)``.  Multi-process: every rank sweeps
    its own contiguous example slice on its own device (independent
    programs, no collectives: a fast rank never stalls on a slow one); the
    model and the table already lie there.  The per-rank `.scores` shards
    merge via :func:`icl_torch.io.scores.write_scores_sharded`.

    ``weights``: optional per-example sweep cost (pair or cell counts for
    the image-keyed tasks): balances the ranks' wall clock, not just their
    example counts (:func:`icl_torch.dist.mesh.predict_partition`).

    ``--eval`` shards too: each rank accumulates its slice's confusion
    counts and :func:`icl_torch.eval.scoredict.merge_sharded` sums the
    (additive) part tables on process 0: the single-process table.
    """
    from icl_torch.dist.mesh import (predict_partition, process_count,
                                     process_index)

    if process_count() == 1:
        return 0, n_examples
    lo, hi = predict_partition(n_examples, weights)
    LOG.info("sharded predict: process %d/%d sweeps examples [%d, %d) "
             "on %s", process_index(), process_count(), lo, hi, rt.device)
    return lo, hi


@dataclasses.dataclass(frozen=True)
class Precision:
    """What ``--matmul_precision`` resolves to on a run's device:
    ``mode`` ("default", "high" or "highest"); ``tf32``, cuBLAS and cuDNN
    take f32 products in TF32; ``head_exact``, the training grid-head
    kernels (K5-K8) run in exact f32, else in their one-pass bf16 mode."""
    mode: str
    tf32: bool
    head_exact: bool


def precision_policy(mode: str | None, device_type: str,
                     predict: bool) -> Precision:
    """The reference's resolution, ``mode or ("high" if predict else
    "default")``, mapped onto the device.  On CUDA ``default`` is TF32 (what
    JAX's ``Precision.DEFAULT`` means on an H100) with the one-pass kernels;
    ``high`` keeps cuBLAS in f32 (parity-grade, where TF32 is not; the card
    has no three-pass product) with the one-pass kernels, whose ``exact``
    the reference sets only under ``highest``; ``highest`` is f32 and exact.
    On the CPU every mode is f32 and exact: XLA:CPU ignores the precision,
    so that is what the reference computes there."""
    mode = mode or ("high" if predict else "default")
    cuda = device_type == "cuda"
    return Precision(mode, tf32=cuda and mode == "default",
                     head_exact=not cuda or mode == "highest")


def apply_precision(args, device) -> Precision:
    """Resolve ``--matmul_precision`` for ``device`` and set the torch flags
    both ways, so no earlier call leaks into this run: TF32 for cuBLAS and
    cuDNN per :func:`precision_policy`; bf16 matrix products sum in f32, as
    XLA's ``preferred_element_type=f32`` does (PyTorch's default lets
    cuBLAS reduce in bf16).  Returns the resolved :class:`Precision`; the
    models take its ``head_exact``."""
    prec = precision_policy(args.matmul_precision, torch.device(device).type,
                            bool(getattr(args, "predict", False)))
    torch.backends.cuda.matmul.allow_tf32 = prec.tf32
    torch.backends.cudnn.allow_tf32 = prec.tf32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    LOG.info("matmul precision %s on %s: f32 products in %s, training "
             "grid-head kernels %s", prec.mode, device,
             "TF32" if prec.tf32 else "f32",
             "exact f32" if prec.head_exact else "one-pass bf16")
    return prec


def resolve_compute_dtype(args) -> torch.dtype:
    """``--compute_dtype`` -> the torch dtype of relation's and affinity's
    models, warning when bf16 scores a predict split (bf16 .scores exceed
    the 1e-5 parity gate)."""
    if args.compute_dtype != "bf16":
        return torch.float32
    if args.predict:
        LOG.warning("bf16 predict exceeds the %.0e parity gate (PERF.md "
                    "states the drift measured on the card); use "
                    "--compute_dtype f32 for parity-grade .scores",
                    PARITY_GATE)
    return torch.bfloat16


def use_fused(args, device: torch.device) -> bool:
    """``--fused``: ``auto`` means "on when the device is CUDA" (the
    kernels); on the CPU ``on`` runs the kernels' plain versions."""
    return args.fused == "on" or (args.fused == "auto"
                                  and device.type == "cuda")


def bucket_spec(args, key: str, default):
    """BucketSpec from the config's ``buckets`` block, or the default."""
    if getattr(args, "buckets", None) and key in args.buckets:
        return BucketSpec(tuple(int(x) for x in args.buckets[key]))
    return BucketSpec(default) if isinstance(default, tuple) else default


def parity_gate() -> float:
    """The port's parity gate against the reference and the Keras oracle,
    f32 with TF32 off: 1e-5 on the CPU and on the card."""
    return PARITY_GATE


def oracle_parity(args, batches, port_probs, oracle_probs,
                  valid_key: str) -> None:
    """``--oracle-parity`` of an image task: the port's probabilities
    (``port_probs(batch)``, a tensor) against the oracle's
    (``oracle_probs(arrays)``, numpy) on the ``valid_key`` cells of the
    first two batches, or of every batch with ``--oracle-parity-full``."""
    diffs = []     # np.max keeps a NaN, which then fails the gate
    for b in batches:
        # the oracle reads numpy: bf16 box features as the f32 values the
        # device sees
        arrays = {k: v.float().numpy() if torch.is_tensor(v) else v
                  for k, v in b.arrays.items()}
        p = port_probs(b).float().cpu().numpy()
        q = oracle_probs(arrays)
        valid = arrays[valid_key]
        diffs.append(np.abs(p[valid] - q[valid]).max(initial=0.0))
        if not args.oracle_parity_full and len(diffs) >= 2:
            break
    report_parity(float(np.max(diffs)) if diffs else None)


def report_parity(max_diff: float | None) -> None:
    """Print the oracle-parity verdict against :func:`parity_gate`;
    ``max_diff`` None: nothing was compared (an empty sharded-predict
    slice), which prints SKIPPED, not a PASS that verified nothing."""
    if max_diff is None:
        LOG.info("oracle parity skipped: empty predict slice")
        print("oracle-parity SKIPPED: empty predict slice")
        return
    gate = parity_gate()
    verdict = "PASS" if max_diff <= gate else "FAIL"
    LOG.info("oracle parity: max|p - p_oracle| = %.3e (gate %.0e): %s",
             max_diff, gate, verdict)
    print(f"oracle-parity {verdict}: max_abs_diff={max_diff:.3e} "
          f"gate={gate:.0e}")


def split_vocab(data_dir: str, split: str) -> set[str]:
    """All words of a split's captions (for embedding-table pruning).

    Native C++ scan when available (icl_torch/native/captions.py
    caption_words); falls back to read_captions whole-file on any grammar
    deviation so the Python reader's exact errors apply — set equality is
    tested in tests/test_torch_native.py."""
    from icl_torch.native.captions import caption_words

    path = os.path.join(data_dir, f"{split}.captions.txt")
    words = caption_words(path)
    if words is not None:
        return words
    words = set()
    for cap in read_captions(path).values():
        words.update(cap.tokens)
    return words


def load_embeddings(args) -> EmbeddingStore:
    path = args.embeddings_file or os.path.join(args.data_dir, "embeddings.txt")
    restrict = None
    if getattr(args, "prune_embeddings", True):
        try:
            restrict = split_vocab(args.data_dir, args.data_split)
            if getattr(args, "eval_every", 0):
                # in-training dev eval reads a second split — prune to the
                # UNION so its words are not spuriously OOV
                try:
                    restrict |= split_vocab(args.data_dir, args.eval_split)
                except FileNotFoundError:
                    pass
        except FileNotFoundError:
            restrict = None
    LOG.info("loading embeddings from %s%s", path,
             f" (pruned to {len(restrict)} split words)" if restrict else "")
    emb = EmbeddingStore.load(path, restrict_to=restrict)
    LOG.info("embeddings: %d words, dim %d", len(emb.vocab), emb.dim)
    return emb


def default_model_dir(args, task: str) -> str:
    return args.model_file or os.path.join(args.data_dir,
                                           f"{task}.model")


def weights_archive(model_dir: str, task: str) -> str | None:
    """``<model_dir>/<task>.npz`` (an ``icl-export`` archive with its
    manifest) when the model dir holds one."""
    path = os.path.join(model_dir, f"{task}.npz")
    return path if os.path.exists(path) else None


def read_model_config(model_dir: str, task: str) -> dict:
    """The widths a model dir's weights were trained at:
    ``model_config.json`` (written after training), else the
    ``model_config`` of the archive's manifest, else nothing."""
    path = os.path.join(model_dir, "model_config.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    archive = weights_archive(model_dir, task)
    if archive and os.path.exists(archive + ".manifest.json"):
        with open(archive + ".manifest.json") as f:
            return json.load(f).get("model_config", {})
    return {}


def restore_for_predict(state, model_dir: str, task: str) -> None:
    """The weights ``--predict`` scores with, into ``state`` in place: the
    model dir's newest checkpoint; else its ``<task>.npz`` archive (already
    loaded when the state was made; its manifest's step is taken); else
    the initial weights, with a warning."""
    from icl_torch.train.checkpoint import Checkpointer

    ckpt = Checkpointer(model_dir)
    if ckpt.latest_step is not None:
        ckpt.restore(state)
        LOG.info("restored checkpoint step %d from %s", state.step, model_dir)
        return
    archive = weights_archive(model_dir, task)
    if archive is None:
        LOG.warning("no checkpoint in %s — predicting from init", model_dir)
        return
    with open(archive + ".manifest.json") as f:
        state.step = int(json.load(f).get("step", 0))


def dump_run_config(args, model_dir: str, rt, precision: Precision) -> None:
    """Write the fully-resolved flag set next to the checkpoints, with the
    world size, the mesh, the backend of the gradient sums and the resolved
    matmul precision (call it on the main process only)."""
    device = rt.device
    os.makedirs(model_dir, exist_ok=True)
    info = {k: v for k, v in vars(args).items()}
    info["_matmul_precision"] = precision.mode
    info["_tf32"] = precision.tf32
    info["_head_exact"] = precision.head_exact
    info["_platform"] = "gpu" if device.type == "cuda" else device.type
    info["_num_devices"] = rt.mesh.world
    info["_mesh"] = dict(rt.mesh.shape)
    info["_reduce_backend"] = rt.backend
    if device.type == "cuda":
        info["_device_kind"] = torch.cuda.get_device_name(device)
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                             text=True, timeout=5).stdout.strip()
        if sha:
            info["_git_sha"] = sha
    except Exception:
        pass
    with open(os.path.join(model_dir, "train_config.json"), "w") as f:
        json.dump(info, f, indent=2, sort_keys=True, default=str)


def loop_config(args, model_dir: str, rt):
    """The train loop's settings, from a task's ``--train`` flags."""
    from icl_torch.train.loop import LoopConfig

    return LoopConfig(epochs=args.epochs, ckpt_dir=model_dir,
                      ckpt_every=args.ckpt_every,
                      profile_dir=args.profile_dir, resume=args.resume,
                      metrics_path=args.metrics_file, seed=args.seed,
                      eval_every=args.eval_every,
                      early_stop=args.early_stop, mesh=rt.mesh)


def finish_training(state, model_dir: str, model_config: dict) -> None:
    """Write the task's ``model_config.json`` (the main process only),
    which ``--predict`` and the server read, and log where the run ended."""
    from icl_torch.dist.mesh import is_main_process

    if is_main_process():
        with open(os.path.join(model_dir, "model_config.json"), "w") as f:
            json.dump(model_config, f)
    LOG.info("trained to step %d; checkpoints in %s", state.step, model_dir)


def default_scores_path(args, task: str) -> str:
    return args.scores_file or os.path.join(
        args.data_dir, f"{args.data_split}.{task}.scores")


def to_device(arrays, device: torch.device):
    """A batcher's arrays (a dict, or a tuple of them) as tensors on
    ``device`` (:func:`icl_torch.data.staging.stage`): on CUDA a batch
    padded into one pinned slab in one ``non_blocking`` copy, any other
    array pinned and copied alone, so the copy overlaps the work already
    queued."""
    from icl_torch.data.staging import stage

    return stage(arrays, device)
