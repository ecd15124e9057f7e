#!/usr/bin/env python3
"""Smoke test of the PyTorch port (icl_torch) on one NVIDIA GPU.

Drives the port's paths at full width with random weights made from a
seed, f32 with TF32 off (and, in phase 10b, ``--compute_dtype bf16``, bf16
matrix products summing in f32; in phases 10 and 10c the ``--train``
default precision, TF32 and the one-pass training kernels): relation
scoring served over HTTP and relation
training (BiLSTM 200 per direction over 300-d word vectors, head 800,
O = 4), affinity scoring served over HTTP, affinity batch predict with
the box ranking, and affinity training (LSTM 200 over 300-d word vectors,
4096-d VGG fc7 box features, head 1024, O = 2), the two mention tasks
(nonvisual and cardinality: an FFNN of hidden 300 over the mean word
vector) trained, predicted and served, the joint inference run, and the
command lines as two data-parallel ranks on the one card:

1. prints the card's name and power limit (nvidia-smi) and the versions;
2. builds the hand-written CUDA sources from icl_torch/csrc (the five
   kernel sources and the two measuring kernels of head_probes.cu), one
   nvcc each, side by side, with the host C++ I/O library of phase 10d
   beside them, and prints ptxas's registers and spills
   (failing on a spill); reads the recurrence library's SASS (cuobjdump):
   HMMA in each bf16 instantiation (h . R on the tensor cores) and none in
   the f32 ones (h . R in FMAs, R on chip or read from device memory); and
   the grid-head libraries' (HEAD_MMA): HMMA in each instantiation of the
   fast dot's tensor-core kernels (grid_head_bf16dot_kernel,
   affinity_rank_bf16dot_kernel) and in no other kernel of grid_head.cu,
   affinity_rank.cu or grid_head_train.cu;
3. checks each kernel against its plain PyTorch version on the card (gate:
   max |kernel - plain| <= 1e-5 * max(1, max |plain|)): the grid head (K1)
   and the recurrence at the served relation shapes, the recurrence's
   training residuals (gates, c) at L=32 B=512, its backward kernel (dx_proj,
   dR against the plain reverse loop) at the relation and affinity train
   shapes and at H in {300, 512}, and the four training
   grid-head kernels (K5 forward, K6 backward, K7 loss forward, K8 loss
   backward) at G in {1, 64}, A = B in {8, 16, 32}, K=800, O=4, dropout
   rate 0 and 0.5 (kernels and plain versions share one hash mask); then
   at the affinity shapes: the box ranking (K9) at G in {1, 4, 64}, A in
   {1, 12, 16, 17}, B in {1, 20, 32, 33, 100}, K=1024 with ragged box
   validity and an image with no valid box, at K in {30, 1022} (no multiple
   of 4), with an operand that is only 4-byte aligned and on another
   column of a wider W2, each twice with equal bits, K1 and K5-K8 (rate 0 and 0.5) at A=16, B in {20, 32},
   K=1024, O=2, and the one-direction recurrence (G=1) at L in {8, 16}, B
   in {16, 1024} (hs, final and the residuals); the recurrence also with a
   batch that is no multiple of its row tile (B=61), one row (B=1), one
   step (L=1), and at H in {8, 9, 64, 200, 201, 256} (the 8-block
   cluster) and {257, 300, 368, 369, 512} (the 16-block one, which holds R
   on chip up to 368 and reads it from device memory above), twice with
   equal bits; the forward grid-head kernels (K1, K5, K7,
   K8) also at ragged register tiles (A, B in {5, 7, 9, 17, 20, 33, 130}),
   K in {30, 50} (no multiple of 4), O in {1, 2, 3, 4, 8}, with an operand
   that is only 4-byte aligned, at weight densities 0, 0.19 and 1, each
   twice with equal bits; K8 in both modes with weights zero but for one
   cell in every other group of four rows, and K6 with a cotangent zero on
   the cells of weight 0 (the backward walks only the cells with a
   cotangent), each twice with equal bits; then times each kernel beside its plain
   version, per call with CUDA events over back-to-back calls, and device
   time alone with the profiler, and prints each kernel's time beside its
   bound: the least time the card could take for the same work, the larger
   of its bytes (every input read once, every output written once) over
   3.35 TB/s, its float operations over 67 T/s (f32 outside the tensor
   cores) and the dropout hash's 32-bit integer operations (each keep
   bit once, in K8 too) over the integer pipe's 16.7 T/s (the hash alone
   and an empty kernel are timed beside them), where the work is what
   this run's data needs (valid steps of the recurrence, cells of weight
   > 0 for K7/K8, cells with a cotangent for K6, valid boxes for K9).
   K5-K8 are timed on kernel_bits.timed_cases' inputs: the relation and
   affinity batch shapes at weight density 0.75, and K7/K8 on the labels
   and weights of the fullest batch of phase 9's train split as the CLIs
   batch it (kernel_bits.trained_batches: 64 images, about 20 % of the
   cells weighted in relation and 42 % in affinity, the live cells in the
   first rows and columns of each image); then the library yardstick of the
   f32 recurrence (icl_torch/tools/lstm_library.py): one call of
   torch.nn.LSTM (cuDNN, TF32 off) over a packed batch beside the port's
   LSTM layer (its input GEMM plus the kernel) with the same weights, at the
   timed recurrence shapes (a BiLSTM at L=32 B=64 H in {200, 300, 512} and
   B=512, the one-direction LSTM at L=16 B=1024, the two larger with the
   weights requiring grad: cuDNN's reserve beside the kernel's residuals),
   lengths in 1..L, the two held to each other within 1e-5 at the valid
   positions and the final states;
4. relation serving: writes a data dir (synthetic 300-d word vectors,
   seeded relation and affinity weights as icl-export archives), serves it
   with icl_torch.serve on 127.0.0.1 and sends Flickr30k-shaped requests (8
   single-image requests, one 8-image request, 4 concurrent ones, a repeat
   that must come back byte-identical); served probs match the plain model
   within 1e-5; the grid head and the recurrence launch over the requests;
5. affinity serving, same server: 8 single-image requests of 12 phrases of
   up to 8 tokens and 20 boxes of 4096 floats, one 4-image request, 4
   concurrent ones and a byte-identical repeat; the served grid matches the
   plain model within 1e-5; the grid head and the recurrence launch;
6. relation training: a planted synthetic dataset of 128 images (up to 32
   tokens, up to 15 mentions), batched 64 images at a time, trains the
   fused model 5 steps with the grid loss at dropout 0.5 and class weights
   [0.3, 1, 1, 1], then 2 steps with null weight 0 (the guard takes the
   pair form), then scores a batch.  At the first step of each form the
   kernel path's loss, metrics and every parameter gradient are held
   against the plain model's from the same params and seeds; every loss is
   finite; all six relation kernels launch in this phase; per-step times of
   the kernel path and the plain path; relation batch predict over the 128
   images in mention pairs per second, both paths;
7. affinity batch predict with ranking: a planted synthetic split of 128
   images (20 boxes each, rewritten at 4096-d, up to 15 phrases) through
   AffinityBatcher (64 images, buckets (8, 16, 32), phrase_len 16);
   probs and box rankings of the fused model against the plain model
   within 1e-5; the grid head, the recurrence and the box ranking launch;
   cells per second of both;
8. affinity training on those batches: 5 grid-loss steps at dropout 0.5,
   then 2 steps with class weights [0, 1] (the guard takes the cell form);
   the first step of each form held against the plain path; the recurrence
   and K5-K8 launch; per-step times;
8b. staging from pinned slabs (``icl_torch.data.staging``): the relation
   and affinity batches of one epoch of a planted 128-image split (boxes
   at 4096-d), padded into the pool's slabs after 0xFF was written over
   them, each in one copy, against the same batches padded into fresh
   zeros and copied array by array: every device tensor bit-equal, at a
   256-byte offset; then the graphed train step (first step eager, then
   captures and replays) from one state on each feed: the same losses;
9. the command lines: a planted split on disk (train 128 images, dev 32,
   boxes at 4096-d) through ``icl_torch.cli.relation.main`` and
   ``icl_torch.cli.affinity.main`` on the card at full width, every
   command line with ``--matmul_precision highest`` (f32, TF32 off, exact
   training kernels: the precision the 1e-5 gates and the bit-equal resume
   are stated in, and what phases 10b, 10c and 11 compare with): ``--train``
   with ``--ckpt_every``, ``--eval_every`` and ``--metrics_file``; a
   shorter run whose end marker is deleted, continued with ``--resume
   auto`` from a periodic checkpoint, must end with the uninterrupted
   run's weights and Adam state bit for bit; ``--predict --eval`` twice
   (byte-identical ``.scores``, ids in dataset order), affinity with
   ``--rank_file`` (each mention's row sums to 1 over its valid boxes);
   the grid head, the recurrence, the fused-CE kernels and the box ranking
   all launch from the command lines; steps and examples per second of
   each ``--train``, pairs and cells per second of each ``--predict``, ms
   the loop stalled per checkpoint save;
10. the mention tasks and the joint run: a planted split on disk with over
   10,000 train mentions (300-d word vectors of 400 words; dev a quarter
   of train, its boxes at 4096-d) through ``icl_torch.cli.nonvisual.main``
   and ``cardinality.main`` on the card at full width (hidden 300, batch
   512, dropout 0.5): ``--train`` with ``--eval_every``, ``--ckpt_every``
   and ``--metrics_file`` (every loss finite), a run cut short and resumed
   bit-equal to the whole one; ``--predict --eval`` twice (byte-identical
   ``.scores``, dev accuracy >= 0.98, the planted gate) and once with
   ``--device cpu`` from the same checkpoint (every probability within
   1e-5: no kernel lies on this path, so the CPU run is what the card is
   held to); ``icl-torch-export`` -> ``icl-torch-import`` into a fresh dir
   -> ``--predict`` with equal bytes; relation and affinity trained an
   epoch into their model dirs, then the server over the four model dirs
   (no ``.npz`` beside them): ``/score/nonvisual`` and
   ``/score/cardinality`` with 64 mentions a request (8 requests, 4
   concurrent ones, a byte-identical repeat) within 1e-5 of the CPU model,
   ``/score/relation`` and ``/score/affinity`` from the same server (the
   mention tasks and relation and affinity train here with no precision
   flag: ``default``; the gates are on predicts, which resolve to
   ``high``),
   ``mention_calls`` and ``mention_items`` on ``/healthz``;
   ``icl_torch.cli.joint.main --with_cardinality --with_rank`` on dev, each
   file byte-equal to the one the task's own CLI wrote, the grid head, the
   recurrence and the box ranking launched from it and no kernel from the
   mention runs; ``icl_torch.cli.evaluate.main`` and ``check.main`` over
   what was written (the accuracy ``--eval`` printed, no finding);
10b. ``--compute_dtype bf16``, its command lines (and the planted runs) with
   ``--matmul_precision highest``, so they compare with phase 9's as they
   did before the precision was ported.  The kernels' bf16 modes against their plain
   versions on the card, each twice with equal bits: the grid head's fast
   dot (K1/K2) at the relation and affinity batch shapes (G=64, A=B=16,
   K=800, O=4; A=16, B=32, K=1024, O=2), ragged tiles, K % 4 != 0, O=8 and
   unaligned operands, gate 1e-5 * max(1, max |plain|) (both round the
   same values to bf16 and sum in f32), and each of its two forms forced
   where the wrapper would take the other (the tensor cores at K % 16 !=
   0, B <= 8, more box tiles than a block's 8, an unaligned operand; the
   FMA form at a batch); the box ranking over the fast-dot
   logits (K9) at G in {4, 64} with ragged validity; the bf16 recurrence
   at G=2 L=32 B in {64, 320}, G=1 L=16 B=1024, H=200, the odd widths
   63 and 255, the 16-block cluster's 300 and 511, one k-step (H = 16),
   368, 369 and 512, one row (B = 1) and one step (L = 1), with its
   residuals, gate BF16_REC_ULPS bf16 units of
   max |plain| (the order of the h . R sum moves a rounded value by a unit
   now and then, and the unit travels down the steps); the bf16 mode of its
   backward on those residuals at the relation and affinity train shapes,
   H in {300, 512} and H = 9, gate BF16_BWD_ULPS.  Then on phase 9's
   split, at full width: ``--train --compute_dtype bf16`` of relation and
   affinity (10 epochs, eval every 5 steps), which must launch the bf16
   recurrence and its backward, K7/K8 in f32 and, in the dev eval, the
   fast-dot grid head, and no f32 recurrence; ``--predict --eval`` of that checkpoint in bf16
   (only the bf16 modes launch) and in f32 (only the f32 kernels);
   ``--predict`` in bf16 over the 128 train images, 64 a batch, whose fast
   dot (and ranking) must take the tensor cores (``mma_launches``); dev
   accuracy in bf16 within 4 points of phase 9's f32 run, printed beside
   the dev split's majority-class rate (both models sit near it: 128
   images at vocabulary 2000 teach neither rule), so the bf16 run's dev
   loss is also held to the f32 run's at every eval within
   BF16_LOSS_CURVE; the two predicts' probabilities within BF16_DRIFT, the
   ``--rank_file`` rows summing to 1; the reference's planted gate
   (tests/integration/test_convergence.py) at full width on a split its
   rule can be learnt from (vocabulary 16, 96 train and 24 dev images, 25
   epochs of 16 images, learn rate 0.01, dropout 0): relation dev accuracy
   >= 93 % in f32 and >= 90 % in bf16, within 4 points of each other, well
   above the majority-class rate; ``icl_torch.cli.joint.main
   --compute_dtype bf16`` over phase 10's model dirs: the mention tasks'
   files the f32 run's bytes, relation, affinity and the ranking within
   BF16_DRIFT of it, the bf16 modes launched and no f32 one.  Each bf16
   mode is also timed beside its f32 mode at the same shape (phase 12),
   with its bound on bf16 bytes (the recurrence also at H = 300 and 512,
   a line each beside the f32 mode's time), and affinity ranked predict
   gets a profile line in bf16 beside the f32 one;
10c. ``--matmul_precision default``, the reference's training precision.
   The one-pass bf16 mode of K5-K8 (``exact=False``: both operands of each
   head contraction rounded to bf16, f32 sums) against its plain versions,
   each twice with equal bits, gate 1e-5 * max(1, max |plain|) (both sides
   round the same f32 values, only the sums' order differs), at the
   relation and affinity batch shapes, ragged tiles, K % 4 != 0, O in
   1..8, an unaligned Y, weight densities 0, 0.19 and 1, rates 0 and 0.5;
   then relation and affinity ``--train`` with no precision flag on phase
   9's split (TF32 and the one-pass kernels), which must launch the
   one-pass K7/K8 once a step, the exact K7 only in the dev evals (as
   many as phase 9's: the reference pins its eval kernel at ``highest``)
   and no other training kernel, with the dev loss at every eval within
   DEFAULT_LOSS_CURVE of phase 9's ``highest`` run and train_config.json
   recording the mode; relation ``--train --null_weight 0`` (the pair
   form), which must launch the one-pass K5/K6 and nothing else of the
   training head; relation ``--train --lstm_hidden_width 300``, wider than
   the 8-block cluster takes, which must run the recurrence kernel's
   16-block cluster at least once a step, warn nothing and launch the
   one-pass K7/K8; the planted gate (tests/integration/
   test_convergence.py, >= PLANTED_GATE %) in ``default`` on phase 10b's
   vocabulary-16 split.  The one-pass modes are timed beside the f32 ones
   (phase 12), their products of bf16 values rated at BF16_RATE;
10d. the port's C++ I/O library (``icl_torch/native``), which must build
   with the host's C++ compiler or load from its cache (the compiler, its
   version and the build's seconds are printed): a synthetic split of
   Flickr30k's test size (1000 images, 5 captions each, up to 3 mentions a
   caption) loads for relation, affinity and nonvisual on the native path
   and on the Python path to equal datasets, ``split_vocab`` gives equal
   words and the relation ``.scores`` write equal bytes, each timed both
   ways on the host clock; relation ``--predict`` on phase 9's dev split
   prints its command wall clock beside its sweep clock, with the native
   and with the Python I/O; and ``--predict --oracle-parity`` must be
   refused at start-up, naming Keras, where Keras cannot be imported;
11. data parallelism (``icl_torch.dist``, ``icl_torch.runtime``).  A world
   of one: ``runtime.init(num_processes=1, process_id=0)`` on the card must
   choose NCCL, and one relation train step at full width through the
   data-parallel step must leave the plain step's weights and loss bit for
   bit (all the NCCL evidence one card can give).  Then two ranks that
   share the card (both ``cuda:0``, so the sums go over gloo through a
   pinned host buffer, and each rank's log must say so), each writing its
   launch counts to a file.  First one train step of relation (the fullest
   batch, and one whose second half is part padding) and of affinity at
   full width through ``icl_torch.testing.dist_worker``: the ranks'
   gradients and weights equal bit for bit, the gradients and the loss
   within 1e-5 x max(1, max|.|) of one process that runs the same two half
   batches one after the other, and all but 1e-4 of the weights within
   1e-5 of its (Adam's first step turns the last bit of a gradient near
   1e-8 into 1e-5 of a weight); one process over the whole batch in one call is printed
   beside it and held to nothing (cuBLAS rounds 64 rows otherwise than 32,
   a ReLU unit within 1e-7 of zero then switches, and a few gradient rows
   move by a hundredth).  Then ``python -m icl_torch.cli.<task>
   --coordinator localhost:<port> --num_processes 2 --process_id k``,
   every command line with ``--matmul_precision highest``:
   relation ``--train`` on phase 9's split (64 images a batch, 32 a rank)
   for an epoch with a checkpoint a step, then resumed to 5 epochs;
   affinity for an epoch (3 steps); nonvisual for an epoch at batch 512;
   each against the same command line as one process from the same seed,
   which feeds 64 rows a call and so rounds otherwise: at the earliest
   step both model dirs still hold (they keep three checkpoints: step 1
   for affinity, 2 for relation) all but 1e-4 of the weights within 1e-5;
   at the end no weight farther than a quarter of learning rate x steps,
   the dev probabilities of the two trained relation models within 5e-3,
   every rank's log saying the ranks ended with one state bit for bit, the
   model dir holding rank 0's files alone; ``--predict --eval`` on dev
   from phase 9's and 10's model dirs (affinity with ``--rank_file``):
   ids in the one-process file's order, probabilities within one unit of
   the sixth decimal, the table printed once and equal, no part file left;
   the recurrence and the fused-CE kernels must launch on BOTH ranks of
   every image-task training run, the grid head (and the box ranking for
   affinity) on both ranks of every predict; then 20 epochs of relation
   training as two ranks and as one process started the same way: steps
   per second of both, ms and bytes a step in the all-reduces; every
   two-rank run from a fresh state must have started bit-equal on both
   ranks (each rank's replicate line);
12. prints the times beside the card, each kernel's bound and share, the
   launches of each kernel per request, predict call and train step, and
   per path (served relation predict, relation train step and predict,
   affinity train step and ranked predict, a mention train step and
   predict call) a profile line: host-clock time per call, device busy
   time, launches, the five longest kernels; the wall clock of the whole
   script;
13. prints one JSON line with every kernel at every timed shape (all nine
    TPU kernels among them, the three bf16 modes and the one-pass mode of
    K5-K8 as kernels of their own): launches over the driven paths, error,
    times,
    bound, and the time of one PyTorch call for the same function: cuDNN's
    LSTM for the f32 recurrence (with the port's layer time beside it),
    null for the others, whose reasons NO_LIBRARY_CALL gives), then, last,
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed phase exits non-zero before the last line; without a CUDA
device it exits 2 at once, and without the repository around it the
imports fail.  Usage, from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import logging
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from icl_torch.cli import affinity as affinity_cli
from icl_torch.cli._common import (RefusedFlagError, precision_policy,
                                   split_vocab)
from icl_torch.cli import cardinality as cardinality_cli
from icl_torch.cli import check as check_cli
from icl_torch.cli import evaluate as evaluate_cli
from icl_torch.cli import export as export_cli
from icl_torch.cli import import_ as import_cli
from icl_torch.cli import joint as joint_cli
from icl_torch.cli import nonvisual as nonvisual_cli
from icl_torch.cli import relation as relation_cli
from icl_torch import native, runtime
from icl_torch.data import staging
from icl_torch.data.buckets import BucketSpec
from icl_torch.data.embeddings import EmbeddingStore
from icl_torch.data.imagebatch import AffinityBatcher, RelationBatcher
from icl_torch.dist import mesh as dist_mesh
from icl_torch.data.pipeline import (load_affinity_dataset,
                                     load_mention_dataset,
                                     load_relation_dataset)
from icl_torch.io.boxes import read_box_feats, write_box_feats
from icl_torch.io.captions import parse_mention_id
from icl_torch.io.feats import read_feats_labels
from icl_torch.io.scores import read_scores, write_scores
from icl_torch.testing import dist_worker
from icl_torch.testing.synth import SynthConfig, generate_dataset
from icl_torch.models.affinity import AffinityModel
from icl_torch.models.cardinality import CardinalityModel
from icl_torch.models.nonvisual import NonvisualModel
from icl_torch.models.relation import RelationModel
from icl_torch.ops import _build
from icl_torch.ops import grid_head as gh_ops
from icl_torch.ops import grid_head_train as ght
from icl_torch.ops.affinity_rank import affinity_rank, affinity_rank_reference
from icl_torch.ops.grid_head import grid_head, grid_head_reference
from icl_torch.ops.lstm_recurrence import (lstm_recurrence,
                                           lstm_recurrence_bwd,
                                           lstm_recurrence_bwd_kernel,
                                           lstm_recurrence_fwd,
                                           lstm_recurrence_reference)
from icl_torch.params import init_params, init_relation_params, save_npz
from icl_torch.serve import serve
from icl_torch.tools.head_probes import (HASH_INT_OPS, empty_launch,
                                         hash_kept)
from icl_torch.tools import kernel_bits, lstm_library
from icl_torch.tools.kernel_bits import (device_ms, device_rows,
                                         one_cell_groups)
from icl_torch.train.checkpoint import Checkpointer
from icl_torch.train.state import create_train_state
from icl_torch.train.steps import (affinity_loss, affinity_predict,
                                   make_affinity_train_step,
                                   make_mention_train_step,
                                   make_relation_train_step, mention_predict,
                                   relation_loss, relation_predict)

KERNEL_GATE = 1e-5     # relative to max(1, max |plain|), f32, TF32 off
PROBS_GATE = 1e-5      # served probs (6 decimals) vs the plain model
DIMS = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 800}
AFF_DIMS = {"emb_dim": 300, "lstm_hidden": 200, "head_hidden": 1024,
            "box_dim": 4096}   # VGG fc7 boxes, phrase LSTM 200, O = 2
VOCAB = 2000
MENTION_DIMS = {"emb_dim": 300, "hidden": 300}   # the mention FFNN
MENTION_BATCH = 512
MENTION_VOCAB = 400    # words of the planted mention split (300-d vectors)
MENTION_GATE = 0.98    # planted dev accuracy of a trained mention task
SEED = 0
RATE = 0.5             # dropout (the relation and affinity CLIs' default)
SOURCES = ("grid_head", "lstm_recurrence", "grid_head_train",
           "affinity_rank", "head_probes", "lstm_recurrence_bwd")
TRAIN_KERNELS = {      # name -> wrapper carrying the launch count
    "grid_head_train_fwd": ght.grid_head_train_fwd,
    "grid_head_train_bwd": ght.grid_head_train_bwd,
    "grid_head_train_loss_fwd": ght.grid_head_train_loss_fwd,
    "grid_head_train_loss_bwd": ght.grid_head_train_loss_bwd,
}
REPLACES = {           # name -> (source, TPU kernel it replaces)
    "grid_head": ("icl_torch/csrc/grid_head.cu", "icl/ops/grid_head.py:147"),
    "lstm_recurrence": ("icl_torch/csrc/lstm_recurrence.cu",
                        "icl/ops/lstm_kernel.py:109"),
    # the recurrence's backward: no Pallas kernel, a reverse lax.scan
    "lstm_recurrence_bwd": ("icl_torch/csrc/lstm_recurrence_bwd.cu",
                            "none (icl/models/rnn.py:86, lax.scan)"),
    "grid_head_train_fwd": ("icl_torch/csrc/grid_head_train.cu",
                            "icl/ops/grid_head_train.py:266"),
    "grid_head_train_bwd": ("icl_torch/csrc/grid_head_train.cu",
                            "icl/ops/grid_head_train.py:303"),
    "grid_head_train_loss_fwd": ("icl_torch/csrc/grid_head_train.cu",
                                 "icl/ops/grid_head_train.py:706"),
    "grid_head_train_loss_bwd": ("icl_torch/csrc/grid_head_train.cu",
                                 "icl/ops/grid_head_train.py:789"),
    "affinity_rank": ("icl_torch/csrc/affinity_rank.cu",
                      "icl/ops/affinity_rank.py:90"),
    # the bf16 modes (--compute_dtype bf16): the reference's fast_dot of
    # both grid-head bodies, the bf16 mode of the streamed recurrence, and
    # K9 over the fast-dot logits
    "grid_head_bf16dot": ("icl_torch/csrc/grid_head.cu",
                          "icl/ops/grid_head.py:147"),
    "lstm_recurrence_bf16": ("icl_torch/csrc/lstm_recurrence.cu",
                             "icl/ops/lstm_kernel.py:282"),
    "lstm_recurrence_bwd_bf16": ("icl_torch/csrc/lstm_recurrence_bwd.cu",
                                 "none (icl/models/rnn.py:86, lax.scan)"),
    "affinity_rank_bf16dot": ("icl_torch/csrc/affinity_rank.cu",
                              "icl/ops/affinity_rank.py:90"),
    # the one-pass bf16 mode of K5-K8 (--matmul_precision default|high):
    # the reference's exact=False, Precision.DEFAULT head dots
    "grid_head_train_fwd_onepass": ("icl_torch/csrc/grid_head_train.cu",
                                    "icl/ops/grid_head_train.py:266"),
    "grid_head_train_bwd_onepass": ("icl_torch/csrc/grid_head_train.cu",
                                    "icl/ops/grid_head_train.py:303"),
    "grid_head_train_loss_fwd_onepass": ("icl_torch/csrc/grid_head_train.cu",
                                         "icl/ops/grid_head_train.py:706"),
    "grid_head_train_loss_bwd_onepass": ("icl_torch/csrc/grid_head_train.cu",
                                         "icl/ops/grid_head_train.py:789"),
}
BF16_KERNELS = {       # name -> the launch count of a kernel's bf16 mode
    "grid_head_bf16dot": grid_head.bf16dot,
    "lstm_recurrence_bf16": lstm_recurrence.bf16,
    "affinity_rank_bf16dot": affinity_rank.bf16dot,
}
ONEPASS_KERNELS = {    # the one-pass bf16 mode (exact=False) of K5-K8
    f"{name}_onepass": fn.onepass for name, fn in TRAIN_KERNELS.items()}
BF16_REC_ULPS = 4      # bf16 recurrence vs its plain version, bf16 units
BF16_BWD_ULPS = 8      # its backward (dx_proj, dR) vs the plain loop
BF16_REC_TIMED = {     # timed bf16 recurrence case -> f32 one, same shape
    "lstm_recurrence_bf16": "lstm_recurrence",
    "lstm_recurrence_bf16 with residuals": "lstm_recurrence with residuals",
    "lstm_recurrence_bf16 G=1": "lstm_recurrence G=1",
    "lstm_recurrence_bf16 H=300": "lstm_recurrence H=300",
    "lstm_recurrence_bf16 H=512": "lstm_recurrence H=512",
}
BF16_DRIFT = 0.05      # bf16 vs f32 probabilities of one checkpoint
BF16_LOSS_CURVE = 0.02  # bf16 vs f32 dev loss at each eval, relative
DEFAULT_LOSS_CURVE = 0.02  # --matmul_precision default vs highest, the same
PLANTED_GATE = 93.0    # tests/integration/test_convergence.py, dev accuracy %
HIGHEST = ["--matmul_precision", "highest"]   # the f32 phases' parity runs
F32_RATE = 67e12       # H100 SXM, f32 outside the tensor cores, operations/s
BF16_RATE = 989e12     # H100 SXM, dense bf16 on the tensor cores, operations/s
TF32_RATE = 494.7e12   # H100 SXM, dense TF32 on the tensor cores, operations/s
INT32_RATE = 16.7e12   # H100 SXM, 32-bit integer: 64 lanes x 132 SMs x 1.98 GHz
HBM_RATE = 3.35e12     # H100 SXM, bytes/s
NO_LIBRARY_CALL = {    # why no one PyTorch call computes the same function
    "grid_head": "fuses broadcast add, ReLU and a narrow dot; the [A,B,K] "
                 "activation never exists",
    "grid_head_train_fwd": "as grid_head, plus the hash dropout",
    "grid_head_train_bwd": "recompute backward with the hash dropout",
    "grid_head_train_loss_fwd": "as grid_head_train_fwd, plus masked "
                                "weighted CE sums",
    "grid_head_train_loss_bwd": "backward of that, one call",
    "affinity_rank": "grid head column plus a masked softmax over boxes",
    "lstm_recurrence_bwd": "cuDNN's LSTM backward takes its own forward's "
                           "reserve space, not these residuals",
    "grid_head_bf16dot": "as grid_head; a bf16 matmul would need the "
                         "[A,B,K] activation materialised",
    "lstm_recurrence_bf16": "cuDNN's bf16 LSTM rounds elsewhere: its gates "
                            "and state stay f32, the eager ops round each",
    "affinity_rank_bf16dot": "as affinity_rank, over the fast-dot column",
    "grid_head_train_fwd_onepass": "as grid_head_train_fwd, operands of the "
                                   "dot rounded to bf16",
    "grid_head_train_bwd_onepass": "as grid_head_train_bwd, operands of the "
                                   "contractions rounded to bf16",
    "grid_head_train_loss_fwd_onepass": "as grid_head_train_loss_fwd, one "
                                        "bf16 pass",
    "grid_head_train_loss_bwd_onepass": "as grid_head_train_loss_bwd, one "
                                        "bf16 pass",
}
# the one PyTorch call that computes a kernel's function: cuDNN's LSTM over a
# packed batch is the f32 recurrence at every valid position and the final
# state (the layers' masks are prefixes), with the input GEMM; timed case ->
# the lstm_library shape at that case's G, L, B, H (and grad: residuals)
LIBRARY_CALL = {"lstm_recurrence": "torch.nn.LSTM over a packed batch "
                                   "(cuDNN): the input GEMM and the "
                                   "recurrence"}
LIBRARY_ROWS = {
    "lstm_recurrence": "BiLSTM L=32 B=64 H=200",
    "lstm_recurrence H=300": "BiLSTM L=32 B=64 H=300",
    "lstm_recurrence H=512": "BiLSTM L=32 B=64 H=512",
    "lstm_recurrence with residuals": "BiLSTM L=32 B=512 H=200, grad",
    "lstm_recurrence G=1": "LSTM L=16 B=1024 H=200",
    "lstm_recurrence G=1 with residuals": "LSTM L=16 B=1024 H=200, grad",
}
# HMMA in the recurrence's instantiations, (dtype, blocks a cluster, R on
# chip, blocks an SM): h . R on the tensor cores in the bf16 mode, in f32
# FMAs in the f32 mode, R on chip or read from device memory
RECURRENCE_MMA = {("bf16", 8, True, 1): True, ("bf16", 8, True, 2): True,
                  ("bf16", 16, True, 1): True, ("bf16", 16, True, 2): True,
                  ("f32", 8, True, 1): False, ("f32", 16, True, 1): False,
                  ("f32", 16, False, 1): False}
# HMMA in the grid head's sources: the fast dot of K1/K2 and K9 on the
# tensor cores in each of its 4 instantiations (8 or 16 boxes an m-tile,
# 16- or 4-byte loads), and none in any other kernel there: the f32 modes
# and every training kernel, their one-pass mode included
HEAD_MMA = {"grid_head": ("grid_head_bf16dot_kernel", 4),
            "affinity_rank": ("affinity_rank_bf16dot_kernel", 4),
            "grid_head_train": (None, 0)}
PREDICT_KERNELS = {"grid_head": grid_head, "lstm_recurrence": lstm_recurrence}
# the train steps' kernels beyond K5-K8: the recurrence's backward
BWD_KERNELS = {"lstm_recurrence_bwd": lstm_recurrence.bwd}


def main() -> int:
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")

    # 1. the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build, one nvcc per source, all at once, beside the host C++ I/O
    # library (phase 10d)
    with ThreadPoolExecutor(len(SOURCES) + 1) as pool:
        host_build = pool.submit(native.build)
        built = list(pool.map(_build.build, SOURCES))
        native_built = host_build.result()
    spilled = []
    for name, (path, secs) in zip(SOURCES, built):
        print(f"build {name}: {secs:.1f} s -> {path.name}")
        log = path.with_suffix(".log")
        if log.exists():
            entry = ""
            for line in log.read_text().splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:   # the mangled name, its file's namespace cut
                    entry = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}"
                                   r"\d+", "", m.group(1)).split("EEv")[0]
                if "registers" in line or "spill" in line:
                    print(f"  {entry}: {line.strip()}")
                if re.search(r"[1-9]\d* bytes spill", line):
                    spilled.append(f"{name} {entry}")
    if spilled:
        raise RuntimeError(f"ptxas reports register spills in {spilled}")
    # h . R on the tensor cores in the bf16 mode: HMMA in each bf16
    # instantiation (both cluster sizes, one and two blocks an SM), none in
    # the f32 ones (RECURRENCE_MMA)
    mma = _recurrence_mma(built[SOURCES.index("lstm_recurrence")][0])
    for (dtype, nc, resident, blocks), n in sorted(mma.items()):
        print(f"sass lstm_cluster_kernel<{dtype}, {nc} blocks, R "
              f"{'on chip' if resident else 'from memory'}, {blocks} an "
              f"SM>: {n} HMMA")
    if not _mma_as_expected(mma):
        raise RuntimeError(f"the recurrence's HMMA per instantiation: {mma}, "
                           f"expected HMMA where RECURRENCE_MMA is True")
    # the fast dot on the tensor cores, nothing else of the head (HEAD_MMA)
    for source in HEAD_MMA:
        hmma = _sass_hmma(built[SOURCES.index(source)][0])
        for name, n in sorted(hmma.items()):
            print(f"sass {source} {name}: {n} HMMA")
        if not _head_mma_as_expected(source, hmma):
            raise RuntimeError(f"{source}: HMMA per kernel {hmma}, expected "
                               f"as HEAD_MMA says")

    # 3. kernels vs plain versions
    gen = torch.Generator(device=dev).manual_seed(SEED)
    failures = []

    def check(what, got, want, gate=KERNEL_GATE, quiet=False):
        err = _max_err(got, want)
        tol = gate * max(1.0, _max_abs(want))
        ok = err <= tol and all(bool(torch.isfinite(g).all())
                                for g in _tuple(got))
        if not ok or not quiet:
            print(f"check {what}: max|d| {err:.3e} (gate {tol:.1e}) "
                  f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)
        return err, tol

    def head_inputs(G, A, B=None, K=DIMS["head_hidden"], O=4):
        B = A if B is None else B
        return (torch.randn(G, A, K, generator=gen, device=dev),
                torch.randn(G, B, K, generator=gen, device=dev),
                torch.randn(K, generator=gen, device=dev),
                torch.randn(K, O, generator=gen, device=dev) / K ** 0.5,
                torch.randn(O, generator=gen, device=dev))

    def train_inputs(G, A, B=None, K=DIMS["head_hidden"], O=4, density=None):
        """The arguments of K5-K8, rate aside, over one random problem;
        `density`: the share of cells of weight > 0 (0.75 if not given)."""
        return kernel_bits.train_inputs(gen, dev, G, A, A if B is None else B,
                                        K, O, density)

    def rec_inputs(L, B, G=2, H=DIMS["lstm_hidden"]):
        """G=2: a BiLSTM's two directions; G=1: the phrase LSTM."""
        lengths = torch.randint(0, L + 1, (B,), generator=gen, device=dev)
        lengths[0], lengths[-1] = 0, L
        t = torch.arange(L, device=dev)[:, None]
        mask = torch.stack([t < lengths, (L - 1 - t) < lengths])[:G]
        return (torch.randn(G, L, B, 4 * H, generator=gen, device=dev),
                mask.contiguous(),
                torch.randn(G, H, 4 * H, generator=gen, device=dev) / H ** .5)

    def bwd_inputs(L, B, G=2, H=DIMS["lstm_hidden"]):
        """The backward's arguments: the forward's residuals over
        rec_inputs and random cotangents."""
        x_proj, mask, R = rec_inputs(L, B, G, H)
        hs, _, gates, c = lstm_recurrence_fwd(x_proj, mask, R,
                                              residuals=True)
        return (gates, c, hs, R, mask,
                torch.randn(G, L, B, H, generator=gen, device=dev),
                torch.randn(G, B, H, generator=gen, device=dev))

    def rank_inputs(G, A, B):
        """K9's arguments: ragged box validity, box 0 always valid, and
        the last image (G > 1) with no valid box."""
        valid = torch.rand(G, B, generator=gen, device=dev) < 0.7
        valid[:, 0] = True
        if G > 1:
            valid[-1] = False
        return (*head_inputs(G, A, B, AFF_DIMS["head_hidden"], 2),
                valid.contiguous())

    plain_of = {"grid_head_train_fwd": ght.grid_head_train_reference,
                "grid_head_train_bwd": ght.grid_head_train_bwd_plain,
                "grid_head_train_loss_fwd": ght.grid_head_train_loss_reference,
                "grid_head_train_loss_bwd": ght.grid_head_train_loss_bwd_plain}

    for G in (1, 8, 64):
        for M in (8, 16, 32):
            args = head_inputs(G, M)
            check(f"grid_head G={G} A=B={M} K=800 O=4", grid_head(*args),
                  grid_head_reference(*args))
    empty = grid_head(*head_inputs(8, 0))
    if empty.shape != (8, 0, 0, 4):
        failures.append("grid_head empty grid")
    print(f"check grid_head empty grid: shape {tuple(empty.shape)}")
    for L in (16, 32, 48):
        for B in (8, 40, 64):
            args = rec_inputs(L, B)
            hs, fin = lstm_recurrence(*args)
            hs_ref, fin_ref = lstm_recurrence_reference(*args)
            check(f"lstm_recurrence L={L} B={B} H=200 hs", hs, hs_ref)
            check(f"lstm_recurrence L={L} B={B} H=200 final", fin, fin_ref)
    for L, B in ((32, 512), (16, 64)):
        args = rec_inputs(L, B)
        got = lstm_recurrence_fwd(*args, residuals=True)
        bare = lstm_recurrence_fwd(*args)
        if not (torch.equal(got[0], bare[0]) and torch.equal(got[1], bare[1])):
            failures.append(f"lstm_recurrence residuals L={L} B={B} changed hs")
        check(f"lstm_recurrence residuals L={L} B={B} H=200 (hs, final, "
              f"gates, c)", got, lstm_recurrence_reference(*args, True))
    # the backward at the relation train step's shapes, the affinity one's
    # and past 256 units, against its plain loop
    for G, L, B, H in ((2, 32, 320, 200), (2, 16, 320, 200),
                       (1, 16, 1024, 200), (2, 16, 61, 300),
                       (2, 8, 61, 512)):
        args = bwd_inputs(L, B, G, H)
        check(f"lstm_recurrence_bwd G={G} L={L} B={B} H={H} (dx_proj, dR)",
              lstm_recurrence_bwd_kernel(*args), lstm_recurrence_bwd(*args))
    for G in (1, 64):
        for M in (8, 16, 32):
            cases = train_inputs(G, M)
            for rate in (0.0, RATE):
                errs = {name: check(f"{name} G={G} A=B={M} rate={rate}",
                                    TRAIN_KERNELS[name](*a, rate),
                                    plain_of[name](*a, rate), quiet=True)
                        for name, a in cases.items()}
                print(f"check grid_head_train K5-K8 G={G} A=B={M} K=800 O=4 "
                      f"rate={rate}: max|d| (gate) " + ", ".join(
                          f"{n[16:]} {e:.2e} ({t:.1e})"
                          for n, (e, t) in errs.items()))
    e_args = train_inputs(8, 0)
    for name, a in e_args.items():
        out = TRAIN_KERNELS[name](*a, RATE)
        if any(t.numel() and t.any() for t in _tuple(out)):
            failures.append(f"{name} empty grid")
    print("check grid_head_train K5-K8 empty grid: zeros")

    # the affinity shapes: K9, K1 and K5-K8 at K=1024 O=2 with A != B, the
    # one-direction recurrence
    K_AFF = AFF_DIMS["head_hidden"]
    errs = []

    def check_rank(what, args, col=1, want=None):
        got = affinity_rank(*args, col)
        want = affinity_rank_reference(*args, col) if want is None else want
        errs.append(check(f"affinity_rank {what}", got, want, quiet=True))
        if got[~args[-1][:, None, :].expand_as(got)].any():
            failures.append(f"affinity_rank {what} invalid box not 0")
        if args[0].shape[0] > 1 and got[-1].any():
            failures.append(f"affinity_rank {what} no valid box: not zeros")
        if not torch.equal(got, affinity_rank(*args, col)):
            failures.append(f"affinity_rank {what} not repeatable")

    for G in (1, 4, 64):
        for A in (1, 12, 16, 17):
            for B in (1, 20, 32, 33, 100):
                check_rank(f"G={G} A={A} B={B} K={K_AFF}",
                           rank_inputs(G, A, B))
    for G, A, B, K, O, col in ((5, 16, 32, 1022, 2, 1), (2, 9, 20, 30, 2, 0),
                               (3, 16, 32, K_AFF, 3, 2),
                               (2, 7, 300, 800, 4, 3)):
        valid = rank_inputs(G, A, B)[-1]
        check_rank(f"G={G} A={A} B={B} K={K} O={O} column {col}",
                   (*head_inputs(G, A, B, K, O), valid), col)
    for G in (4, 64):
        args = rank_inputs(G, 16, 32)
        want = affinity_rank_reference(*args)
        for which in (0, 1, 2, 3):
            moved = list(args)
            moved[which] = _offset_view(moved[which])
            check_rank(f"G={G} A=16 B=32 K={K_AFF}, operand {which} "
                       f"unaligned", moved, want=want)
    bad = [f for f in failures if f.startswith("affinity_rank")]
    print(f"check affinity_rank K9 at G in (1, 4, 64), A in (1, 12, 16, 17), "
          f"B in (1, 20, 32, 33, 100), K={K_AFF}; K in (30, 1022), O in (3, "
          f"4) and another column; unaligned operands: {len(errs)} cases, "
          f"max|d| {max(e for e, _ in errs):.3e} (gate "
          f"{min(t for _, t in errs):.1e}), invalid boxes 0, an image with "
          f"no valid box zeros, repeated bits equal; {len(bad)} failures")
    n0 = affinity_rank.launches
    empty = affinity_rank(*rank_inputs(4, 0, 20))
    if empty.shape != (4, 0, 20) or affinity_rank.launches != n0:
        failures.append("affinity_rank empty grid")
    print(f"check affinity_rank empty grid: shape {tuple(empty.shape)}, no "
          f"launch")
    for B in (20, 32):
        for G in (4, 64):
            args = head_inputs(G, 16, B, K_AFF, 2)
            check(f"grid_head G={G} A=16 B={B} K={K_AFF} O=2",
                  grid_head(*args), grid_head_reference(*args))
        cases = train_inputs(64, 16, B, K_AFF, 2)
        for rate in (0.0, RATE):
            errs = {name: check(f"{name} G=64 A=16 B={B} K={K_AFF} O=2 "
                                f"rate={rate}",
                                TRAIN_KERNELS[name](*a, rate),
                                plain_of[name](*a, rate), quiet=True)
                    for name, a in cases.items()}
            print(f"check grid_head_train K5-K8 G=64 A=16 B={B} K={K_AFF} "
                  f"O=2 rate={rate}: max|d| (gate) " + ", ".join(
                      f"{n[16:]} {e:.2e} ({t:.1e})"
                      for n, (e, t) in errs.items()))
    for L in (8, 16):
        for B in (16, 1024):
            args = rec_inputs(L, B, G=1)
            got = lstm_recurrence_fwd(*args, residuals=True)
            bare = lstm_recurrence(*args)
            if not (torch.equal(got[0], bare[0])
                    and torch.equal(got[1], bare[1])):
                failures.append(f"lstm_recurrence G=1 L={L} B={B} "
                                f"residuals changed hs")
            check(f"lstm_recurrence G=1 L={L} B={B} H=200 (hs, final, gates, "
                  f"c)", got, lstm_recurrence_reference(*args, True))
    # a batch that is no multiple of the kernel's 8-row tile, one row, one
    # step, and other widths than the models' 200: one unit a block (8), a
    # ragged last block (9, 201); 256 is the widest the 8-block cluster
    # takes, above it the 16-block one (R on chip up to 368, read from
    # device memory above, up to 512)
    for G, L, B, H in ((2, 32, 61, 200), (2, 16, 61, 64), (2, 16, 61, 256),
                       (1, 16, 9, 256), (2, 8, 5, 64), (2, 16, 61, 300),
                       (1, 8, 9, 257), (2, 8, 17, 512), (2, 8, 13, 8),
                       (2, 8, 13, 9), (2, 16, 13, 201), (1, 8, 9, 368),
                       (1, 8, 9, 369), (2, 16, 1, 200), (2, 1, 13, 200)):
        args = rec_inputs(L, B, G, H)
        got = lstm_recurrence_fwd(*args, residuals=True)
        again = lstm_recurrence_fwd(*args, residuals=True)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            failures.append(f"lstm_recurrence G={G} L={L} B={B} H={H} not "
                            f"repeatable")
        check(f"lstm_recurrence G={G} L={L} B={B} H={H} (hs, final, gates, "
              f"c), repeated bits equal", got,
              lstm_recurrence_reference(*args, True))
    # the forward family's tiling (K1, K5, K7, K8; K6 beside them): ragged
    # register tiles, K no multiple of 4 (the scalar form) or of a 128-wide
    # pass, every head width, K splits; each call twice for equal bits
    def twice(what, fn, plain, args):
        got = fn(*args)
        err = check(what, got, plain(*args), quiet=True)
        if not all(torch.equal(a, b)
                   for a, b in zip(_tuple(got), _tuple(fn(*args)))):
            failures.append(f"{what} not repeatable")
        return err

    def with_rate(fn, rate=RATE):
        return lambda *a: fn(*a, rate)

    for G, A, B, K, O in ((1, 5, 7, 30, 1), (2, 7, 9, 50, 2),
                          (2, 9, 17, 800, 3), (1, 17, 20, 1024, 4),
                          (2, 20, 33, 50, 8), (3, 33, 5, 800, 8),
                          (2, 9, 130, 16, 2), (1, 16, 16, 800, 4)):
        shape = f"G={G} A={A} B={B} K={K} O={O}"
        errs = {"K1": twice(f"grid_head {shape}", grid_head,
                            grid_head_reference, head_inputs(G, A, B, K, O))}
        for name, a in train_inputs(G, A, B, K, O).items():
            errs[name[16:]] = twice(f"{name} {shape} rate={RATE}",
                                    with_rate(TRAIN_KERNELS[name]),
                                    with_rate(plain_of[name]), a)
        print(f"check grid head K1, K5-K8 {shape} rate={RATE}, repeated "
              f"bits equal: max|d| (gate) " + ", ".join(
                  f"{n} {e:.2e} ({t:.1e})" for n, (e, t) in errs.items()))
    # an operand that is only 4-byte aligned (a view one float into its
    # allocation): the scalar form
    for G, A, B, K, O in ((8, 16, 16, 800, 4), (4, 16, 20, K_AFF, 2)):
        shape = f"G={G} A={A} B={B} K={K} O={O}"
        for which in (0, 1, 3):
            args = list(head_inputs(G, A, B, K, O))
            want = grid_head_reference(*args)
            args[which] = _offset_view(args[which])
            check(f"grid_head {shape}, operand {which} unaligned",
                  grid_head(*args), want, quiet=True)
        cases = train_inputs(G, A, B, K, O)
        errs = {}
        for name in ("grid_head_train_fwd", "grid_head_train_loss_fwd",
                     "grid_head_train_loss_bwd"):
            a = list(cases[name])
            want = plain_of[name](*a, RATE)
            a[1] = _offset_view(a[1])
            errs[name[16:]] = twice(f"{name} {shape}, Y unaligned",
                                    with_rate(TRAIN_KERNELS[name]),
                                    lambda *_, w=want: w, a)
        print(f"check grid head K1, K5, K7, K8 {shape} with an unaligned "
              f"operand: max|d| (gate) " + ", ".join(
                  f"{n} {e:.2e} ({t:.1e})" for n, (e, t) in errs.items()))
    # K7 and K8 skip cells of weight 0: every density, and all-zero sums and
    # gradients at density 0
    for G, A, B, K, O in ((64, 16, 16, 800, 4), (8, 16, 32, K_AFF, 2)):
        for density in (0.0, 0.19, 1.0):
            cases = train_inputs(G, A, B, K, O, density)
            errs = {}
            for name in ("grid_head_train_loss_fwd",
                         "grid_head_train_loss_bwd"):
                what = f"{name} G={G} A={A} B={B} K={K} O={O} weight " \
                       f"density {density}"
                errs[name[16:]] = twice(what, with_rate(TRAIN_KERNELS[name]),
                                        with_rate(plain_of[name]),
                                        cases[name])
                if density == 0.0 and any(
                        t.any() for t in _tuple(TRAIN_KERNELS[name](
                            *cases[name], RATE))):
                    failures.append(f"{what}: not all zero")
            print(f"check grid head K7, K8 G={G} A={A} B={B} K={K} O={O} "
                  f"weight density {density}: max|d| (gate) " + ", ".join(
                      f"{n} {e:.2e} ({t:.1e})" for n, (e, t) in errs.items()))
    # K6 and K8 walk only the cells with a cotangent: K8 with weights zero
    # but for one cell in every other group of four rows (none in the
    # others), K6 with a cotangent zero on the cells of weight 0; both
    # modes (the one-pass K8 in its two halves, as phase 10c holds it),
    # each twice with equal bits
    errs = {}
    for G, A, B, K, O, kind in ((2, 17, 20, K_AFF, 2, "K8"),
                                (2, 17, 20, 800, 4, "K8"),
                                (64, 16, 16, 800, 4, "K6")):
        case = train_inputs(G, A, B, K, O, density=0.19)
        if kind == "K8":
            name = "grid_head_train_loss_bwd"
            a = list(case[name])
            a[7] = one_cell_groups(G, A, B, gen, dev)
        else:
            name = "grid_head_train_bwd"
            a = list(case[name])
            a[5] = a[5] * (case["grid_head_train_loss_bwd"][7] > 0)[..., None]
        fn = TRAIN_KERNELS[name]
        for rate in (0.0, RATE):
            for exact in (True, False):
                what = (f"{name} {'f32' if exact else 'one-pass'} G={G} "
                        f"A={A} B={B} K={K} O={O} rate={rate}, "
                        + ("one cell in every other four-row group"
                           if kind == "K8" else
                           "cotangent zero at weight 0"))
                if exact or kind == "K6":
                    errs[what] = twice(
                        what, lambda *x, r=rate, e=exact: fn(*x, r, e),
                        lambda *x, r=rate, e=exact: plain_of[name](*x, r, e),
                        a)
                    continue
                g3 = torch.empty(G, A, B, O, device=dev)
                got = fn(*a, rate, False, g3_out=g3)
                if not all(torch.equal(x, y) for x, y in zip(
                        got, fn(*a, rate, False, g3_out=g3))):
                    failures.append(f"{what} not repeatable")
                errs[what + ": g3"] = check(
                    what + ": g3", g3, ght.grid_head_train_dlogits_plain(
                        *a, rate, False), quiet=True)
                errs[what] = check(what, got, (*ght.grid_head_train_bwd_plain(
                    *a[:4], a[5], g3, rate, False), g3.sum((0, 1, 2))),
                    quiet=True)
    print(f"check grid head K8 with one live cell in every other four-row "
          f"group, K6 with a cotangent zero at weight 0, f32 and one-pass, "
          f"rates 0 and {RATE}, each twice with equal bits: {len(errs)} "
          f"cases, worst max|d| {max(e / t for e, t in errs.values()):.3f} "
          f"of the gate")
    if failures:
        raise RuntimeError(f"kernel checks failed: {failures}")

    # timings: the served 8-image shape for the predict kernels; the
    # training batch's shape (64 images, 16 mentions) for the training ones.
    # A case: (kernel, wrapper call, plain call, inputs, shape, TPU kernel
    # line, operations this run's data needs).
    def head_ops(kind, G, A, B, K, O, cells=None, rate=0.0):
        """Operations of a grid-head kernel over `cells` cells (all, unless
        the data needs fewer), as (float operations, integer operations, bf16
        tensor-core operations: none in the f32 modes).
        Per element of [cells, K]: add and ReLU (2) and the O-wide dot (2
        O) forward; the mask of z > 0, dh and dW2 (4 O), dz, dX, dY and
        the two scalings (6) backward; with dropout the hash (10 32-bit
        integer operations, HASH_INT_OPS) and the scaling (1 or 2 float
        ones).  The two kinds are rated apart: float at F32_RATE, integer
        at INT32_RATE, the rate the hash-only probe confirms on the card.
        K8 recomputes the forward and runs the backward over one mask: the
        function needs each keep bit once, so its hash counts once (the
        kernels hash it twice, once a launch)."""
        cells = G * A * B if cells is None else cells
        drop = ght.dropout_applies(rate)
        fwd = cells * K * (2 + 2 * O + (1 if drop else 0))
        bwd = cells * K * (6 + 4 * O + (2 if drop else 0))
        hashed = cells * K * HASH_INT_OPS if drop else 0
        pre = G * A * K                                     # X + b1
        return {"fwd": (pre + fwd, hashed, 0), "bwd": (pre + bwd, hashed, 0),
                "loss_fwd": (pre + fwd + cells * 6 * O, hashed, 0),
                "loss_bwd": (2 * pre + fwd + bwd + cells * 8 * O, hashed, 0),
                "rank": (pre + cells * K * 4 + cells * 6, 0, 0)}[kind]

    def rec_ops(args):
        """2 H 4H per valid (row, step) for h . R, and about 10 per unit
        for the gates, as (float, integer, bf16 tensor-core, TF32
        tensor-core operations).  In bf16, h . R is a product of bf16
        values summed in f32: tensor-core work, rated at BF16_RATE.  In
        f32, the least time the card could take for f32-grade products is
        three TF32 passes on the tensor cores (3xTF32 holds the 1e-5 gate,
        as a build of the kernel showed on the card), rated at TF32_RATE,
        whatever the kernel takes (f32 FMAs)."""
        H = args[2].shape[1]
        rows = int(args[1].sum())
        if args[2].dtype == torch.bfloat16:
            return rows * 10 * H, 0, rows * 8 * H * H, 0
        return rows * 10 * H, 0, 0, 3 * rows * 8 * H * H

    def bwd_ops(args):
        """dgates . R^T and the dR GEMM's h . dgates at every valid (row,
        step) but the first step's (2 4H H each), and about 20 operations
        a unit for the gate cotangents, all f32 outside the tensor cores
        (F32_RATE)."""
        H, mask = args[0].shape[-1] // 4, args[4]
        return (int(mask[:, 1:].sum()) * 16 * H * H
                + int(mask.sum()) * 20 * H, 0, 0)

    cases = {}

    def add_case(name, kernel, fn, plain, inputs, shape, ops, replaces=None):
        """`ops`: (float, integer, bf16 tensor-core[, TF32 tensor-core])
        operations."""
        cases[name] = {"kernel": kernel, "fn": fn, "plain": plain,
                       "inputs": inputs, "shape": shape,
                       "ops": (*ops, 0, 0)[:4],
                       "replaces": replaces or REPLACES[kernel][1]}

    # the timed K5-K8 inputs (kernel_bits.timed_cases, which kernel_bits.py
    # --times also times): the relation and affinity batch shapes at density
    # 0.75, and K7/K8 on the weights and labels of a real batch of phase 9's
    # split as the CLIs batch it (64 images)
    train_timed = kernel_bits.timed_cases(
        gen, dev, kernel_bits.trained_batches(SEED), DIMS["head_hidden"],
        K_AFF)

    def add_train_cases(suffix, exact=True):
        """The timed K5-K8 cases of `suffix` (the kernels of
        `train_timed[suffix]`); `exact` False: their one-pass bf16 mode, whose products of bf16 values (the logit dot
        forward, g . W2 and hd . g backward: 2 O and 4 O operations an
        element) are rated at BF16_RATE, and each rounded activation adds
        an operation an element."""
        kinds = {"grid_head_train_fwd": "fwd", "grid_head_train_bwd": "bwd",
                 "grid_head_train_loss_fwd": "loss_fwd",
                 "grid_head_train_loss_bwd": "loss_bwd"}
        dots = {"fwd": (2, 1), "bwd": (4, 1), "loss_fwd": (2, 1),
                "loss_bwd": (6, 2)}   # bf16 products / O, roundings
        (G, A, B, K, O), inputs = train_timed[suffix]
        for name, a in inputs.items():
            weighted = "loss" in name     # weight-0 cells need no work
            # K6 walks the cells with a non-zero cotangent, K7/K8 those of
            # weight > 0
            cells = (int((a[7] > 0).sum()) if weighted else
                     int((a[5] != 0).any(-1).sum()) if "bwd" in name
                     else None)
            ops = head_ops(kinds[name], G, A, B, K, O, cells, RATE)
            kernel = name if exact else f"{name}_onepass"
            if not exact:
                per, rounded = dots[kinds[name]]
                n = (G * A * B if cells is None else cells) * K
                ops = fast(ops, n // K, K, per * O)
                ops = (ops[0] + (rounded - 1) * n, ops[1], ops[2])
            add_case(kernel + suffix, kernel,
                     (lambda f=TRAIN_KERNELS[name], a=a: f(*a, RATE, exact)),
                     (lambda f=plain_of[name], a=a: f(*a, RATE, exact)), a,
                     f"G={G} A={A} B={B} K={K} O={O} rate={RATE}"
                     + (f", {cells} of {G * A * B} cells of weight > 0"
                        if weighted else ""), ops)

    head_args = head_inputs(8, 16)
    add_case("grid_head", "grid_head", lambda: grid_head(*head_args),
             lambda: grid_head_reference(*head_args), head_args,
             "G=8 A=B=16 K=800 O=4", head_ops("fwd", 8, 16, 16, 800, 4))
    for G in (1, 64):    # one served image; the relation batch predict
        a = head_inputs(G, 16)
        add_case(f"grid_head G={G}", "grid_head", (lambda a=a: grid_head(*a)),
                 (lambda a=a: grid_head_reference(*a)), a,
                 f"G={G} A=B=16 K=800 O=4",
                 head_ops("fwd", G, 16, 16, 800, 4))
    rec_args = rec_inputs(32, 64)
    add_case("lstm_recurrence", "lstm_recurrence",
             lambda: lstm_recurrence(*rec_args),
             lambda: lstm_recurrence_reference(*rec_args), rec_args,
             "G=2 L=32 B=64 H=200", rec_ops(rec_args),
             "icl/ops/lstm_kernel.py:282")      # both directions, full batch
    wide_rec = rec_inputs(32, 64, H=300)     # --lstm_hidden_width 300
    add_case("lstm_recurrence H=300", "lstm_recurrence",
             lambda: lstm_recurrence(*wide_rec),
             lambda: lstm_recurrence_reference(*wide_rec), wide_rec,
             "G=2 L=32 B=64 H=300, the 16-block cluster", rec_ops(wide_rec))
    big_rec = rec_inputs(32, 512)
    add_case("lstm_recurrence with residuals", "lstm_recurrence",
             lambda: lstm_recurrence_fwd(*big_rec, residuals=True),
             lambda: lstm_recurrence_reference(*big_rec, residuals=True),
             big_rec, "G=2 L=32 B=512 H=200", rec_ops(big_rec))
    add_train_cases("")
    add_train_cases(" on a trained batch")
    # the affinity shapes: batch predict and training (64 images, 16
    # phrases, 32 boxes), the served 4-image request, the phrase LSTM over
    # 64 x 16 phrases
    for G in (64, 4):
        a = rank_inputs(G, 16, 32)
        add_case("affinity_rank" if G == 64 else f"affinity_rank G={G}",
                 "affinity_rank", (lambda a=a: affinity_rank(*a)),
                 (lambda a=a: affinity_rank_reference(*a)), a,
                 f"G={G} A=16 B=32 K={K_AFF}",
                 head_ops("rank", G, 16, 32, K_AFF, 2,
                          cells=16 * int(a[-1].sum())))
    aff_head = head_inputs(64, 16, 32, K_AFF, 2)
    add_case("grid_head affinity", "grid_head",
             lambda: grid_head(*aff_head),
             lambda: grid_head_reference(*aff_head), aff_head,
             f"G=64 A=16 B=32 K={K_AFF} O=2",
             head_ops("fwd", 64, 16, 32, K_AFF, 2),
             "icl/ops/grid_head.py:173")        # the tiled kernel's size
    add_train_cases(" affinity")
    add_train_cases(" affinity on a trained batch")
    phrase_rec = rec_inputs(16, 1024, G=1)
    add_case("lstm_recurrence G=1", "lstm_recurrence",
             lambda: lstm_recurrence(*phrase_rec),
             lambda: lstm_recurrence_reference(*phrase_rec), phrase_rec,
             "G=1 L=16 B=1024 H=200", rec_ops(phrase_rec))
    add_case("lstm_recurrence G=1 with residuals", "lstm_recurrence",
             lambda: lstm_recurrence_fwd(*phrase_rec, residuals=True),
             lambda: lstm_recurrence_reference(*phrase_rec, residuals=True),
             phrase_rec, "G=1 L=16 B=1024 H=200", rec_ops(phrase_rec))
    # K3/K4 bwd: the relation train step's BiLSTM and the affinity one's
    # phrase LSTM; the call (the kernel, R's transpose and the dR GEMM)
    # against the plain loop
    for (G, L, B), label in (((2, 32, 320), "lstm_recurrence_bwd"),
                             ((1, 16, 1024), "lstm_recurrence_bwd G=1")):
        a = bwd_inputs(L, B, G)
        add_case(label, "lstm_recurrence_bwd",
                 (lambda a=a: lstm_recurrence_bwd_kernel(*a)),
                 (lambda a=a: lstm_recurrence_bwd(*a)), a,
                 f"G={G} L={L} B={B} H=200", bwd_ops(a))
    # the bf16 modes, each at the shape of an f32 case above: the bound
    # counts their bytes (bf16 in and out for the recurrence) and rates
    # their products of bf16 values at BF16_RATE
    def fast(ops, cells, K, dot):
        """A fast-dot mode's operations: the `dot` multiply-add operations
        a cell and k leave the f32 count for the bf16 one, and each
        activation element gains a rounding."""
        return (ops[0] - cells * K * dot + cells * K, ops[1],
                cells * K * dot)

    rel_fast = head_inputs(64, 16)
    add_case("grid_head_bf16dot G=64", "grid_head_bf16dot",
             lambda: grid_head(*rel_fast, fast_dot=True),
             lambda: grid_head_reference(*rel_fast, fast_dot=True), rel_fast,
             "G=64 A=B=16 K=800 O=4",
             fast(head_ops("fwd", 64, 16, 16, 800, 4), 64 * 16 * 16, 800,
                  2 * 4))
    aff_fast = head_inputs(64, 16, 32, K_AFF, 2)
    add_case("grid_head_bf16dot affinity", "grid_head_bf16dot",
             lambda: grid_head(*aff_fast, fast_dot=True),
             lambda: grid_head_reference(*aff_fast, fast_dot=True), aff_fast,
             f"G=64 A=16 B=32 K={K_AFF} O=2",
             fast(head_ops("fwd", 64, 16, 32, K_AFF, 2), 64 * 16 * 32,
                  K_AFF, 2 * 2),
             "icl/ops/grid_head.py:173")
    rank_fast = rank_inputs(64, 16, 32)
    n_valid = 16 * int(rank_fast[-1].sum())
    add_case("affinity_rank_bf16dot", "affinity_rank_bf16dot",
             lambda: affinity_rank(*rank_fast, fast_dot=True),
             lambda: affinity_rank_reference(*rank_fast, 1, True), rank_fast,
             f"G=64 A=16 B=32 K={K_AFF}",
             fast(head_ops("rank", 64, 16, 32, K_AFF, 2, cells=n_valid),
                  n_valid, K_AFF, 2))
    for name, f32_args, res, shape in (
            ("lstm_recurrence_bf16", rec_args, False, "G=2 L=32 B=64 H=200"),
            ("lstm_recurrence_bf16 with residuals", big_rec, True,
             "G=2 L=32 B=512 H=200"),
            ("lstm_recurrence_bf16 G=1", phrase_rec, False,
             "G=1 L=16 B=1024 H=200")):
        a = (f32_args[0].bfloat16(), f32_args[1], f32_args[2].bfloat16())
        add_case(name, "lstm_recurrence_bf16",
                 (lambda a=a, r=res: lstm_recurrence_fwd(*a, residuals=r)),
                 (lambda a=a, r=res: lstm_recurrence_reference(*a, r)), a,
                 shape, rec_ops(a), "icl/ops/lstm_kernel.py:282")
    # the one-pass bf16 mode of K5-K8 (--matmul_precision default|high) on
    # the same inputs
    for suffix in train_timed:
        add_train_cases(suffix, exact=False)
    # the recurrence past 256 units in both modes: H = 300 (R on chip in
    # both) and 512 (f32 reads R from device memory, bf16 keeps it on chip)
    widest_rec = rec_inputs(32, 64, H=512)
    add_case("lstm_recurrence H=512", "lstm_recurrence",
             lambda: lstm_recurrence(*widest_rec),
             lambda: lstm_recurrence_reference(*widest_rec), widest_rec,
             "G=2 L=32 B=64 H=512, the 16-block cluster",
             rec_ops(widest_rec))
    for H, f32_args in ((300, wide_rec), (512, widest_rec)):
        a = (f32_args[0].bfloat16(), f32_args[1], f32_args[2].bfloat16())
        add_case(f"lstm_recurrence_bf16 H={H}", "lstm_recurrence_bf16",
                 (lambda a=a: lstm_recurrence_fwd(*a)),
                 (lambda a=a: lstm_recurrence_reference(*a)), a,
                 f"G=2 L=32 B=64 H={H}, the 16-block cluster", rec_ops(a),
                 "icl/ops/lstm_kernel.py:282")
    # the fast dot at a served relation request (G = 8: too little work
    # for the tensor cores, the FMA form) and at a K no multiple of 16 (the
    # tensor cores' last chunk read +0 past K), the f32 mode beside it
    for G, K in ((8, 800), (64, 792)):
        a = head_inputs(G, 16, K=K)
        add_case(f"grid_head_bf16dot G={G}" + (f" K={K}" if K != 800 else ""),
                 "grid_head_bf16dot",
                 (lambda a=a: grid_head(*a, fast_dot=True)),
                 (lambda a=a: grid_head_reference(*a, fast_dot=True)), a,
                 f"G={G} A=B=16 K={K} O=4",
                 fast(head_ops("fwd", G, 16, 16, K, 4), G * 16 * 16, K,
                      2 * 4))
        if K != 800:
            add_case(f"grid_head G={G} K={K}", "grid_head",
                     (lambda a=a: grid_head(*a)),
                     (lambda a=a: grid_head_reference(*a)), a,
                     f"G={G} A=B=16 K={K} O=4",
                     head_ops("fwd", G, 16, 16, K, 4))
    timing = {}
    for name, c in cases.items():
        got, want = c["fn"](), c["plain"]()
        nbytes = _nbytes(c["inputs"]) + _nbytes(_tuple(got))
        f_ops, i_ops, b_ops, x_ops = c["ops"]
        t_ops = max(f_ops / F32_RATE, i_ops / INT32_RATE,
                    b_ops / BF16_RATE, x_ops / TF32_RATE) * 1e3
        t_bytes = nbytes / HBM_RATE * 1e3
        timing[name] = {"shape": c["shape"], "kernel": c["kernel"],
                        "replaces": c["replaces"],
                        "max_abs_err": _max_err(got, want),
                        "ms": _time_ms(c["fn"]),
                        "plain_ms": _time_ms(c["plain"]),
                        "device_ms": device_ms(c["fn"]),
                        "plain_device_ms": device_ms(c["plain"]),
                        "ops": f_ops, "int_ops": i_ops, "bf16_ops": b_ops,
                        "tf32_ops": x_ops,
                        "bytes": nbytes,
                        "bound_ms": max(t_ops, t_bytes),
                        "bound_by": ("operations" if t_ops >= t_bytes
                                     else "bytes")}
    del cases
    # the two yardsticks of the bounds: an empty kernel (the floor under a
    # launch) and the dropout hash alone (the integer pipe's rate)
    probes = {"empty_ms": device_ms(lambda: empty_launch(dev))}
    for name, (G, A, B, K) in (("R", (64, 16, 16, 800)),
                               ("A", (64, 16, 32, K_AFF))):
        seeds = torch.arange(1, G + 1, dtype=torch.int32, device=dev)
        kept = hash_kept(seeds, A, B, K, RATE)
        if not torch.equal(kept[:2].long(), ght.dropout_keep_mask(
                seeds[:2], A, B, K, RATE).sum(-1)):
            raise RuntimeError("the hash probe disagrees with the mask")
        ms = device_ms(lambda: hash_kept(seeds, A, B, K, RATE))
        probes[name] = (f"G={G} A={A} B={B} K={K}", ms,
                        G * A * B * K * HASH_INT_OPS / ms / 1e9)
    # the library yardstick: cuDNN's LSTM beside the port's layer at the
    # timed f32 recurrence shapes, the two held to each other
    library = {r["shape"]: r for r in lstm_library.measure(dev, SEED)}
    for name, shape in LIBRARY_ROWS.items():
        r = library[shape]
        timing[name]["library_ms"] = r["library_ms"]
        timing[name]["layer_ms"] = r["layer_ms"]
        ok = r["max_abs_diff"] <= KERNEL_GATE
        print(f"check cuDNN LSTM vs the port's layer [{shape}], valid "
              f"positions and final states: max|d| {r['max_abs_diff']:.3e} "
              f"(gate {KERNEL_GATE:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"cuDNN LSTM vs the port's layer [{shape}]")
    if failures:
        raise RuntimeError(f"library yardstick disagrees: {failures}")

    # 4. serving
    with tempfile.TemporaryDirectory(prefix="icl_chip_smoke_") as d:
        generate_dataset(d, "train", SynthConfig(
            num_images=1, emb_dim=DIMS["emb_dim"], vocab_size=VOCAB,
            seed=SEED))
        flat = init_relation_params(SEED, DIMS)
        save_npz(f"{d}/relation.npz", flat, {"task": "relation", **DIMS})
        aff_flat = init_params("affinity", SEED, AFF_DIMS)
        save_npz(f"{d}/affinity.npz", aff_flat,
                 {"task": "affinity", "phrase_enc": "lstm", **AFF_DIMS})
        httpd = serve(d, port=0, warmup="basic")
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        try:
            result = _drive(httpd)
            scorer = httpd.RequestHandlerClass.scorer
            plain = RelationModel(DIMS["emb_dim"], DIMS["lstm_hidden"],
                                  DIMS["head_hidden"], fused=False,
                                  device=dev)
            plain.load_flat(flat)
            prepped = [scorer._prep_relation_image(img)
                       for img in result["images"]]
            want = relation_predict(plain, scorer.table, scorer._stack_arrays(
                [p[1] for p in prepped])).cpu().numpy()
            got = np.array([[p["probs"] for p in im["pairs"]]
                            for im in result["batch_body"]["images"]])
            perr = float(np.abs(got - want[:, :got.shape[1]]).max())
            print(f"check served probs vs plain model on the card: "
                  f"max|d| {perr:.3e} (gate {PROBS_GATE:.0e}) "
                  f"{'ok' if perr <= PROBS_GATE else 'FAIL'}")
            if perr > PROBS_GATE:
                raise RuntimeError("served probs disagree with the plain "
                                   "model")
            served_batch = scorer._stack_arrays([p[1] for p in prepped])
            served_model = scorer.tasks["relation"]["model"]
            served_one = scorer._stack_arrays([prepped[0][1]])
            served_profiles = [
                _profile("served relation predict, the 8-image request's "
                         "arrays", lambda: relation_predict(
                             served_model, scorer.table, served_batch)),
                _profile("the same, one image", lambda: relation_predict(
                    served_model, scorer.table, served_one))]
            # 5. affinity serving, same server
            aff_result = _drive_affinity(httpd)
            aff_plain = AffinityModel(**AFF_DIMS, fused=False, device=dev)
            aff_plain.load_flat(aff_flat)
            prepped = [scorer._prep_affinity_image(img)
                       for img in aff_result["images"]]
            want = affinity_predict(aff_plain, scorer.table,
                                    scorer._stack_arrays(
                                        [p[1] for p in prepped])
                                    ).cpu().numpy()
            got = np.array([im["grid"]
                            for im in aff_result["batch_body"]["images"]])
            perr = float(np.abs(
                got - want[:, :got.shape[1], :got.shape[2]]).max())
            print(f"check served affinity grid vs plain model on the card: "
                  f"max|d| {perr:.3e} (gate {PROBS_GATE:.0e}) "
                  f"{'ok' if perr <= PROBS_GATE else 'FAIL'}")
            if perr > PROBS_GATE:
                raise RuntimeError("served affinity grid disagrees with the "
                                   "plain model")
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=10)

    # 6. relation training
    train = _train(dev, check)
    if failures:
        raise RuntimeError(f"training checks failed: {failures}")

    # 7. affinity batch predict with ranking; 8. affinity training
    aff = _affinity(dev, check)
    if failures:
        raise RuntimeError(f"affinity checks failed: {failures}")

    # 8b. batches staged from the pinned slabs
    _staging(dev)

    with tempfile.TemporaryDirectory(prefix="icl_chip_cli_") as cli_dir, \
            tempfile.TemporaryDirectory(prefix="icl_chip_mention_") as men_dir:
        # 9. the command lines
        cli = _cli(cli_dir)

        # 10. the mention tasks, their server endpoints, the joint run
        mention = _mention(men_dir)

        # 10b. --compute_dtype bf16: the kernels' bf16 modes, relation and
        # affinity on phase 9's split, the joint run over phase 10's dirs
        bf16 = _bf16(dev, check, cli_dir, men_dir, cli["accuracy"])

        # 10c. --matmul_precision default: the one-pass kernels, relation
        # and affinity trained with no flag on phase 9's split, the planted
        # gate
        onepass = _onepass(dev, check, cli_dir, cli["per_unit"])

        # 10d. the native I/O library: built, both paths equal and timed,
        # --predict's clocks, the oracle flag refused without Keras
        native_io = _native_io(cli_dir, native_built)

        # 11. a world of one over NCCL; two ranks on the one card
        ranks = _dist(cli_dir, men_dir, card)

    if failures:     # a kernel check of a later phase (10b, 10c)
        raise RuntimeError(f"kernel checks failed: {failures}")

    # 12. times, each beside the card
    for name, t in timing.items():
        print(f"time {name} [{t['shape']}]: per call kernel {t['ms']:.4f} "
              f"ms, plain {t['plain_ms']:.4f} ms; device kernel "
              f"{t['device_ms']:.4f} ms, plain {t['plain_device_ms']:.4f} ms "
              f"({card})")
        print(f"bound {name} [{t['shape']}]: {t['ops'] / 1e9:.4f} G float, "
              f"{t['int_ops'] / 1e9:.4f} G integer and "
              f"{t['bf16_ops'] / 1e9:.4f} G bf16 and "
              f"{t['tf32_ops'] / 1e9:.4f} G TF32 tensor-core operations, "
              f"{t['bytes'] / 1e6:.3f} MB -> {t['bound_ms']:.4f} "
              f"ms by {t['bound_by']}; device {t['device_ms']:.4f} ms = "
              f"{t['device_ms'] / t['bound_ms']:.1f} x the bound, share "
              f"{t['bound_ms'] / t['device_ms']:.3f}; one PyTorch call: "
              + (f"{LIBRARY_CALL[t['kernel']]} {t['library_ms']:.4f} ms, "
                 f"the port's layer (input GEMM + kernel) "
                 f"{t['layer_ms']:.4f} ms [{LIBRARY_ROWS[name]}]"
                 if "library_ms" in t else
                 f"none ({NO_LIBRARY_CALL[t['kernel']]})") + f" ({card})")
    for bf, f32 in BF16_REC_TIMED.items():
        t, f = timing[bf], timing[f32]
        print(f"time bf16 recurrence [{t['shape']}]: device "
              f"{t['device_ms']:.4f} ms, the f32 mode {f['device_ms']:.4f} "
              f"ms at that shape ({f32}), bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']} ({card})")
    print(f"probe empty kernel: device {probes['empty_ms']:.4f} ms a launch, "
          f"the floor under the served shapes' bounds ({card})")
    for name in ("R", "A"):
        shape, ms, rate = probes[name]
        print(f"probe hash only [{shape}]: device {ms:.4f} ms, {rate:.2f} T "
              f"integer operations/s at {HASH_INT_OPS} an element; the "
              f"bounds rate them at {INT32_RATE / 1e12:.1f} T/s ({card})")
    lat = result["latency_ms"]
    print(f"time request p50: client {lat['client_p50']:.2f} ms over "
          f"{lat['n']} single-image requests, server predict p50 "
          f"{lat['server_p50']} ms; 8-image request {lat['batch_ms']:.2f} ms "
          f"({card})")
    print(f"time train step [{train['shape']}], grid loss, dropout {RATE}: "
          f"kernel path {train['step_ms']:.2f} ms, plain path "
          f"{train['plain_step_ms']:.2f} ms per step ({card})")
    print(f"time relation batch predict [{train['predict_shape']}]: kernel "
          f"path {train['pairs_per_s']:.0f} mention pairs/s "
          f"({train['predict_ms']:.2f} ms per batch), plain path "
          f"{train['plain_pairs_per_s']:.0f} pairs/s "
          f"({train['plain_predict_ms']:.2f} ms per batch) ({card})")
    lat = aff_result["latency_ms"]
    print(f"time affinity request p50: client {lat['client_p50']:.2f} ms "
          f"over {lat['n']} single-image requests (12 phrases, 20 boxes of "
          f"4096), server predict p50 {lat['server_p50']} ms; 4-image "
          f"request {lat['batch_ms']:.2f} ms ({card})")
    print(f"time affinity batch predict with ranking [{aff['shape']}]: "
          f"kernel path {aff['cells_per_s']:.0f} cells/s "
          f"({aff['predict_ms']:.2f} ms per batch), plain path "
          f"{aff['plain_cells_per_s']:.0f} cells/s "
          f"({aff['plain_predict_ms']:.2f} ms per batch) ({card})")
    print(f"time affinity train step [{aff['shape']}], grid loss, dropout "
          f"{RATE}: kernel path {aff['step_ms']:.2f} ms, plain path "
          f"{aff['plain_step_ms']:.2f} ms per step ({card})")

    for line in (cli["times"] + mention["times"] + bf16["times"]
                 + onepass["times"] + native_io["times"] + ranks["times"]):
        print(f"time {line} ({card})")
    for line in (served_profiles + train["profiles"] + aff["profiles"]
                 + mention["profiles"] + onepass["profiles"]):
        print(f"{line} ({card})")
    print(f"time whole script: {time.perf_counter() - t_script:.1f} s, the "
          f"kernels' build included ({card})")

    # 13. result lines: launches summed over the phases that drove the paths
    launches = dict.fromkeys(REPLACES, 0)
    for phase in (result, aff_result, train, aff, cli, mention, bf16, onepass,
                  ranks):
        for k, n in phase["launches"].items():
            launches[k] += n
        for unit, counts in phase["per_unit"].items():
            print(f"launches per {unit}: "
                  + ", ".join(f"{k} {n}" for k, n in counts.items() if n))
    idle = [k for k, n in launches.items() if n < 1]
    if idle:
        raise RuntimeError(f"not launched on any driven path: {idle}")
    kernels = [{"name": name, "route": "cuda",
                "source": REPLACES[t["kernel"]][0], "replaces": t["replaces"],
                "shape": t["shape"], "launches": launches[t["kernel"]],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "device_ms": t["device_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"),
                **({"layer_ms": t["layer_ms"]} if "layer_ms" in t else {})}
               for name, t in timing.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _sass(lib) -> str:
    """The built library's SASS (cuobjdump beside nvcc)."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def _sass_hmma(lib) -> dict:
    """{kernel: HMMA instructions} of every function in the built
    library's SASS; a mangled name is cut to the kernel and its template
    arguments, as the build lines print it."""
    out, key = {}, None
    for line in _sass(lib).splitlines():
        m = re.search(r"Function : (.+?)\s*$", line)
        if m:
            key = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "",
                         m.group(1)).split("EEv")[0]
            out[key] = 0
        elif key is not None and "HMMA" in line:
            out[key] += 1
    return out


def _head_mma_as_expected(source: str, hmma: dict) -> bool:
    """Whether a grid-head source's SASS has HMMA in each of HEAD_MMA's
    instantiations of its fast-dot kernel, as many as it says, and none
    in its other kernels (at least one of those)."""
    kernel, n = HEAD_MMA[source]
    mine = {k: v for k, v in hmma.items() if kernel and kernel in k}
    return (len(mine) == n and all(mine.values()) and len(hmma) > n
            and not any(v for k, v in hmma.items() if k not in mine))


def _recurrence_mma(lib) -> dict:
    """{(dtype, blocks a cluster, R on chip, blocks an SM): HMMA
    instructions} of each lstm_cluster_kernel instantiation in the built
    library's SASS (cuobjdump beside nvcc)."""
    sass = _sass(lib)
    out, key = {}, None
    for line in sass.splitlines():
        # the mangled name, or the demangled one
        m = (re.search(r"Function : \S*lstm_cluster_kernelI(13__nv_bfloat16"
                       r"|f)Li(\d+)ELb([01])ELi(\d)E", line)
             or re.search(r"Function : .*lstm_cluster_kernel<(__nv_bfloat16|"
                          r"float), (\d+), (true|false), (\d+)>", line))
        if m:
            key = ("f32" if m.group(1) in ("f", "float") else "bf16",
                   int(m.group(2)), m.group(3) in ("1", "true"),
                   int(m.group(4)))
            out[key] = 0
        elif "Function :" in line:
            key = None
        elif key is not None and "HMMA" in line:
            out[key] += 1
    if not out:
        raise RuntimeError(f"no lstm_cluster_kernel in the SASS of {lib}")
    return out


def _mma_as_expected(mma: dict) -> bool:
    """Whether the SASS has exactly RECURRENCE_MMA's instantiations, with
    HMMA in those it marks True and none in the others."""
    return (set(mma) == set(RECURRENCE_MMA)
            and all(bool(mma[k]) == want for k, want in RECURRENCE_MMA.items()))


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _max_abs(x) -> float:
    return max((t.abs().max().item() for t in _tuple(x) if t.numel()),
               default=0.0)


def _max_err(got, want) -> float:
    got, want = _tuple(got), _tuple(want)
    if len(got) != len(want) or any(a.shape != b.shape
                                    for a, b in zip(got, want)):
        return float("inf")
    return max(((a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want) if b.numel()), default=0.0)


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of t that starts one float into its allocation:
    4-byte aligned only."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    if view.data_ptr() % 16 == 0:
        raise RuntimeError("the offset view is still 16-byte aligned")
    return view


def _nbytes(tensors) -> int:
    """Bytes of the tensors among `tensors`, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def _time_ms(fn, iters: int = 50) -> float:
    """Mean time per fn() call over iters back-to-back calls, by CUDA
    events: the device's time, or the host's where the host is slower."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile(what: str, fn, iters: int = 5) -> str:
    """One line on where fn()'s time goes on the card: host-clock time per
    call (ending in a synchronize), the summed device time of its kernels
    and their share of it, launches per call, and the five kernels that
    take the most device time (sums of what the profiler recorded)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters * 1e3
    rows = sorted(device_rows(fn, iters),
                  key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / iters / 1e3
    return (f"profile {what}: {wall:.3f} ms per call, device busy "
            f"{busy:.3f} ms ({busy / wall:.0%}), "
            f"{sum(e.count for e in rows) / iters:.0f} launches; top: "
            + "; ".join(f"{_kernel_name(e.key)} "
                        f"{e.self_device_time_total / iters / 1e3:.3f} ms "
                        f"x{e.count / iters:.0f}" for e in rows[:5]))


def _kernel_name(key: str) -> str:
    """A profiler row's kernel name without namespaces and arguments."""
    key = key.replace("(anonymous namespace)::", "").replace("void ", "")
    name = key.split("(")[0].split("<")[0].split("::")[-1]
    inner = re.search(r"(\w*Functor\w*|cutlass_\w+)", key)   # what it applies
    return (f"{name}[{inner.group(1)}]" if inner else name)[:60]


def _train(dev, check) -> dict:
    """The training path: 5 grid-loss steps, 2 pair-form steps, a scoring
    pass; counts the launches of all six kernels over it."""
    with tempfile.TemporaryDirectory(prefix="icl_chip_train_") as d:
        generate_dataset(d, "train", SynthConfig(
            planted=True, emb_dim=DIMS["emb_dim"], vocab_size=VOCAB,
            max_caption_len=32, max_mentions_per_caption=3, num_images=128,
            seed=SEED))
        emb = EmbeddingStore.load(f"{d}/embeddings.txt")
        ds = load_relation_dataset(d, "train", emb)
    table = torch.from_numpy(emb.table).to(dev)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.arrays.items()}
               for b in RelationBatcher(images_per_batch=64,
                                        build_grid=True).batches(ds)]
    # the fullest batch first: 64 images of up to 32 tokens, 16 mentions
    batches.sort(key=lambda b: -int(b["pair_valid"].sum()))
    model = RelationModel(**DIMS, fused=True, dropout=RATE, device=dev)
    state = create_train_state(model, seed=SEED)
    plain = RelationModel(**DIMS, fused=False, dropout=RATE, device=dev)

    kernels = {**PREDICT_KERNELS, **TRAIN_KERNELS, **BWD_KERNELS}
    _reset(kernels)
    losses = []
    for form, cw, n in (("grid", [0.3, 1.0, 1.0, 1.0], 5),
                        ("pair", [0.0, 1.0, 1.0, 1.0], 2)):
        step = make_relation_train_step(class_weights=cw, grid_loss=True)
        for i in range(n):
            batch = batches[len(losses) % len(batches)]
            # every step against the plain model's from the same params and
            # seeds: the first eager, the rest replays of the step's graphs
            plain.load_flat(model.flat_params())
            plain.zero_grad(set_to_none=True)
            loss_p, want = relation_loss(
                plain, table, batch, state.dropout_seeds(
                    batch["tokens"].shape[0]),
                torch.tensor(cw, device=dev), step.grid_loss)
            loss_p.backward()
            # held past backward, the plain model's autograd graph would
            # keep its parameters' gradient nodes on the default stream,
            # where a CUDA graph capture of its step cannot go
            want = {k: v.detach() for k, v in want.items()}
            del loss_p
            how = _graph_path(step)
            metrics = step(state, table, batch)
            how = how(step)
            loss = metrics["loss"].item()
            losses.append(loss)
            print(f"train step {state.step} ({form} form, {how}): loss "
                  f"{loss:.6f} acc {metrics['acc'].item():.4f}")
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {state.step}")
            for k, v in want.items():
                check(f"train {form} form step {i + 1} ({how}) {k}: kernel "
                      f"path vs plain", metrics[k], v)
            grads = dict(plain.named_parameters())
            errs = [check(f"train {form} form step {i + 1} grad {k}", p.grad,
                          grads[k].grad, quiet=True)
                    for k, p in model.named_parameters()]
            print(f"check train {form} form step {i + 1} ({how}): "
                  f"{len(errs)} parameter gradients, kernel path vs plain, "
                  f"max|d| {max(e for e, _ in errs):.3e} (smallest gate "
                  f"{min(t for _, t in errs):.1e})")
    probs = relation_predict(model, table, batches[0])
    valid = batches[0]["pair_valid"]
    if (not torch.isfinite(probs).all()
            or (probs.sum(-1) - 1).abs().max().item() > 1e-5):
        raise RuntimeError("scoring after training: bad probabilities")
    acc = ((probs.argmax(-1) == batches[0]["pair_label"]) & valid).sum() \
        / valid.sum()
    launches = _read(kernels, "the relation training path")
    print(f"train: losses {[round(x, 6) for x in losses]}, pair accuracy "
          f"after training {acc.item():.4f} over {int(valid.sum())} pairs")

    # per-step times of both paths on the fullest batch, grid loss
    batch = batches[0]
    step = make_relation_train_step(class_weights=[0.3, 1.0, 1.0, 1.0],
                                    grid_loss=True)
    plain_state = create_train_state(plain, params=model.flat_params())
    per_step = _replay_counts(step, state, table, batch, kernels,
                              "one relation train step, grid loss")
    profiles = [_profile(f"relation train step, grid loss, kernel path "
                         f"[I={batch['tokens'].shape[0]}]",
                         lambda: step(state, table, batch)),
                _profile("relation predict, kernel path, the same batch",
                         lambda: relation_predict(model, table, batch))]
    times = {}
    for name, st in (("kernel", state), ("plain", plain_state)):
        for _ in range(2):      # a new state's eager step, then its capture
            step(st, table, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step(st, table, batch)
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) / 5 * 1e3
    # batch predict over the whole planted set, both paths in turns
    pairs = sum(int(b["pair_valid"].sum()) for b in batches)
    plain.load_flat(model.flat_params())
    for b in batches:
        check("relation batch predict probs: kernel path vs plain",
              relation_predict(model, table, b),
              relation_predict(plain, table, b), gate=PROBS_GATE, quiet=True)
    _reset(PREDICT_KERNELS)
    relation_predict(model, table, batch)
    per_predict = _read(PREDICT_KERNELS, "one relation batch predict call")
    predict_s = {}
    for name, m in (("kernel", model), ("plain", plain), ("kernel2", model),
                    ("plain2", plain)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            relation_predict(m, table, b)
        torch.cuda.synchronize()
        predict_s[name] = time.perf_counter() - t0
    t_k = min(predict_s["kernel"], predict_s["kernel2"])
    t_p = min(predict_s["plain"], predict_s["plain2"])
    I, C, L = batch["tokens"].shape
    return {"launches": launches, "step_ms": times["kernel"],
            "pairs_per_s": pairs / t_k, "plain_pairs_per_s": pairs / t_p,
            "predict_ms": t_k / len(batches) * 1e3,
            "plain_predict_ms": t_p / len(batches) * 1e3,
            "predict_shape": f"{len(batches)} batches of {I} images, "
                             f"{pairs} valid pairs",
            "per_unit": {"relation train step": per_step,
                         "relation batch predict": per_predict},
            "profiles": profiles,
            "plain_step_ms": times["plain"],
            "shape": f"I={I} C={C} L={L} M={batch['m_cap'].shape[1]}"}


def _image(rng, k: int) -> dict:
    """A Flickr30k-shaped image: 5 captions of 12..32 tokens, 16 mentions
    spread over them; no "pairs" key, so all 120 pairs i < j are scored."""
    caps = [[f"w{int(t):03d}" for t in rng.integers(0, VOCAB, n)]
            for n in rng.integers(12, 33, 5)]
    ments = []
    for m in range(16):
        c = m % 5
        first = int(rng.integers(0, len(caps[c]) - 1))
        ments.append({"caption": c, "first": first,
                      "last": min(first + int(rng.integers(0, 3)),
                                  len(caps[c]) - 1)})
    return {"id": f"img{k}", "captions": caps, "mentions": ments}


def _post(url: str, obj: dict,
          path: str = "/score/relation") -> tuple[int, bytes, float]:
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read()
        return r.status, body, (time.perf_counter() - t0) * 1e3


def _check_body(body: dict, n_images: int) -> None:
    if len(body["images"]) != n_images:
        raise RuntimeError(f"{len(body['images'])} images in the response, "
                           f"{n_images} sent")
    for im in body["images"]:
        probs = np.array([p["probs"] for p in im["pairs"]])
        if probs.shape != (120, 4) or not np.isfinite(probs).all():
            raise RuntimeError(f"bad probs for {im['id']}: {probs.shape}")
        if np.abs(probs.sum(-1) - 1).max() > 1e-5:
            raise RuntimeError(f"probs of {im['id']} do not sum to 1")


def _drive(httpd) -> dict:
    """The served path: HTTP requests through the server; counts launches."""
    url = f"http://127.0.0.1:{httpd.server_port}"
    rng = np.random.default_rng(SEED)
    singles = [_image(rng, k) for k in range(8)]
    batch = [_image(rng, 8 + k) for k in range(8)]
    _reset(PREDICT_KERNELS)

    lat, first = [], None
    for img in singles:
        status, raw, ms = _post(url, {"images": [img]})
        if status != 200:
            raise RuntimeError(f"single request: HTTP {status}")
        _check_body(json.loads(raw), 1)
        lat.append(ms)
        first = first or raw
    status, raw, batch_ms = _post(url, {"images": batch})
    if status != 200:
        raise RuntimeError(f"8-image request: HTTP {status}")
    batch_body = json.loads(raw)
    _check_body(batch_body, 8)

    results = [None] * 4

    def fire(k):
        results[k] = _post(url, {"images": [singles[k]]})

    threads = [threading.Thread(target=fire, args=(k,)) for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    for r in results:
        if r is None or r[0] != 200:
            raise RuntimeError(f"concurrent request failed: {r and r[0]}")
        _check_body(json.loads(r[1]), 1)

    status, again, _ = _post(url, {"images": [singles[0]]})
    if again != first:
        raise RuntimeError("a repeated request gave different bytes")
    print("check repeated request: byte-identical JSON ok")
    launches = _read(PREDICT_KERNELS, "the relation requests")
    _reset(PREDICT_KERNELS)
    _post(url, {"images": [singles[1]]})
    per_unit = _read(PREDICT_KERNELS, "one relation request")

    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    if health["status"] != "ok" or health["coalescer"]["items"] < 22:
        raise RuntimeError(f"bad /healthz: {health}")
    print(f"check /healthz: {json.dumps(health)}")
    lat.sort()
    return {"images": batch, "batch_body": batch_body, "launches": launches,
            "per_unit": {"relation request": per_unit},
            "latency_ms": {
                "client_p50": lat[len(lat) // 2], "n": len(lat),
                "server_p50": health["latency_ms"]["relation"]["p50_ms"],
                "batch_ms": batch_ms}}


def _graph_path(step):
    """Before a train step, a function that names, after it, the path the
    step took through its CUDA graphs (``icl_torch.train.graphs``)."""
    on = step.graphed._on
    n = None if on is None else len(on.graphs)

    def after(step):
        graphs = step.graphed._on.graphs
        if n is None:
            return "eager"
        if len(graphs) == n:
            return "replay"
        return ("capture, replay" if list(graphs.values())[-1] is not None
                else "eager, its capture failed")
    return after


def _replay_counts(step, state, table, batch, kernels, phase) -> dict:
    """The launch counts of one train step that replays its graph, held to
    those of the eager step that begins the new step maker's path."""
    _reset(kernels)
    step(state, table, batch)                   # eager
    eager = _count(kernels, f"{phase}, eager")
    step(state, table, batch)                   # the capture
    _reset(kernels)
    step(state, table, batch)
    replay = _count(kernels, f"{phase}, a replay of its graph")
    if replay != eager:
        raise RuntimeError(f"{phase}: a replay counts {replay}, the eager "
                           f"step {eager}")
    return replay


def _reset(kernels: dict) -> None:
    for fn in kernels.values():
        fn.launches = 0


def _count(kernels: dict, phase: str) -> dict:
    """The launch counts since the last reset."""
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"check launches over {phase}: {launches}")
    return launches


def _read(kernels: dict, phase: str) -> dict:
    """The launch counts of a phase; raises if a kernel did not launch."""
    launches = _count(kernels, phase)
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel was not launched over {phase}: "
                           f"{launches}")
    return launches


def _affinity_image(rng, k: int) -> dict:
    """A Flickr30k-shaped affinity request: 12 phrases of 1..8 tokens, 20
    candidate boxes of 4096 VGG fc7 features (post-ReLU, 4 decimals)."""
    phrases = [[f"w{int(t):03d}" for t in rng.integers(0, VOCAB, n)]
               for n in rng.integers(1, 9, 12)]
    boxes = np.round(np.maximum(rng.normal(size=(20, AFF_DIMS["box_dim"])),
                                0.0), 4)
    return {"id": f"aff{k}", "phrases": phrases, "boxes": boxes.tolist()}


def _check_affinity_body(body: dict, n_images: int) -> None:
    if len(body["images"]) != n_images:
        raise RuntimeError(f"{len(body['images'])} images in the response, "
                           f"{n_images} sent")
    for im in body["images"]:
        grid = np.array(im["grid"])
        if grid.shape != (12, 20, 2) or not np.isfinite(grid).all():
            raise RuntimeError(f"bad grid for {im['id']}: {grid.shape}")
        if np.abs(grid.sum(-1) - 1).max() > 1e-5:
            raise RuntimeError(f"probs of {im['id']} do not sum to 1")


def _drive_affinity(httpd) -> dict:
    """The served affinity path: HTTP requests; counts launches."""
    url = f"http://127.0.0.1:{httpd.server_port}"
    path = "/score/affinity"
    rng = np.random.default_rng(SEED + 1)
    singles = [_affinity_image(rng, k) for k in range(8)]
    batch = [_affinity_image(rng, 8 + k) for k in range(4)]
    _reset(PREDICT_KERNELS)

    lat, first = [], None
    for img in singles:
        status, raw, ms = _post(url, {"images": [img]}, path)
        if status != 200:
            raise RuntimeError(f"single affinity request: HTTP {status}")
        _check_affinity_body(json.loads(raw), 1)
        lat.append(ms)
        first = first or raw
    status, raw, batch_ms = _post(url, {"images": batch}, path)
    if status != 200:
        raise RuntimeError(f"4-image affinity request: HTTP {status}")
    batch_body = json.loads(raw)
    _check_affinity_body(batch_body, 4)

    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(
            lambda img: _post(url, {"images": [img]}, path), singles[:4]))
    for r in results:
        if r[0] != 200:
            raise RuntimeError(f"concurrent affinity request: HTTP {r[0]}")
        _check_affinity_body(json.loads(r[1]), 1)

    status, again, _ = _post(url, {"images": [singles[0]]}, path)
    if again != first:
        raise RuntimeError("a repeated affinity request gave different "
                           "bytes")
    print("check repeated affinity request: byte-identical JSON ok")
    launches = _read(PREDICT_KERNELS, "the affinity requests")
    _reset(PREDICT_KERNELS)
    _post(url, {"images": [singles[1]]}, path)
    per_unit = _read(PREDICT_KERNELS, "one affinity request")
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    lat.sort()
    return {"images": batch, "batch_body": batch_body, "launches": launches,
            "per_unit": {"affinity request": per_unit},
            "latency_ms": {
                "client_p50": lat[len(lat) // 2], "n": len(lat),
                "server_p50": health["latency_ms"]["affinity"]["p50_ms"],
                "batch_ms": batch_ms}}


def _widen_boxes(path: str, dim: int, seed: int) -> None:
    """Rewrite a synthetic split's box features at ``dim`` (VGG fc7's 4096):
    the 64 written features first (they carry the planted box signature),
    then post-ReLU noise."""
    ids, feats = read_box_feats(path)
    rng = np.random.default_rng(seed)
    wide = np.maximum(rng.normal(size=(len(ids), dim)), 0.0).astype(
        np.float32)
    wide[:, :feats.shape[1]] = feats
    write_box_feats(path, ids, wide)


def _affinity(dev, check) -> dict:
    """Affinity batch predict with the box ranking, then 5 grid-loss and 2
    cell-form train steps, over a planted 128-image split at full width;
    counts the launches of each phase."""
    with tempfile.TemporaryDirectory(prefix="icl_chip_affinity_") as d:
        generate_dataset(d, "train", SynthConfig(
            planted=True, emb_dim=AFF_DIMS["emb_dim"], vocab_size=VOCAB,
            max_boxes_per_image=20, num_images=128, seed=SEED))
        _widen_boxes(f"{d}/train.boxes.npz", AFF_DIMS["box_dim"], SEED)
        emb = EmbeddingStore.load(f"{d}/embeddings.txt")
        ds = load_affinity_dataset(d, "train", emb)
        batcher = AffinityBatcher(images_per_batch=64,
                                  mention_spec=BucketSpec((8, 16, 32)),
                                  box_spec=BucketSpec((8, 16, 32)),
                                  phrase_len=16, with_ids=False)
        batches = [{k: torch.from_numpy(v).to(dev)
                    for k, v in b.arrays.items()}
                   for b in batcher.batches(ds)]
    table = torch.from_numpy(emb.table).to(dev)
    batches.sort(key=lambda b: -int(b["grid_valid"].sum()))
    I, M, L = batches[0]["phrase_tokens"].shape
    B = batches[0]["box_feats"].shape[1]
    shape = f"I={I} M={M} B={B} L={L}, {len(batches)} batches"
    flat = init_params("affinity", SEED, AFF_DIMS)
    model = AffinityModel(**AFF_DIMS, fused=True, dropout=RATE, device=dev)
    plain = AffinityModel(**AFF_DIMS, fused=False, dropout=RATE, device=dev)
    model.load_flat(flat)
    plain.load_flat(flat)

    # 7. batch predict with ranking: kernel path, held against the plain
    rank_kernels = {**PREDICT_KERNELS, "affinity_rank": affinity_rank}
    _reset(rank_kernels)
    outs = [affinity_predict(model, table, b, rank=True) for b in batches]
    launches = _read(rank_kernels, "affinity batch predict")
    _reset(rank_kernels)
    affinity_predict(model, table, batches[0], rank=True)
    per_unit = {"affinity ranked predict": _count(
        rank_kernels, "one affinity predict call with ranking")}
    for n, (b, got) in enumerate(zip(batches, outs)):
        want = affinity_predict(plain, table, b, rank=True)
        check(f"affinity batch {n} probs: kernel path vs plain", got[0],
              want[0])
        check(f"affinity batch {n} ranking: kernel path vs plain", got[1],
              want[1])
        if not torch.isfinite(got[1]).all() or got[1][
                ~b["box_valid"][:, None, :].expand_as(got[1])].any():
            raise RuntimeError("ranking: invalid box not 0")
    cells = sum(int(b["grid_valid"].sum()) for b in batches)
    times = {}
    for name, m in (("kernel", model), ("plain", plain), ("kernel2", model),
                    ("plain2", plain)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            affinity_predict(m, table, b, rank=True)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
    t_k = min(times["kernel"], times["kernel2"])
    t_p = min(times["plain"], times["plain2"])

    # 8. training: 5 grid-loss steps, 2 cell-form steps (weights [0, 1])
    state = create_train_state(model, seed=SEED, params=flat)
    train_kernels = {"lstm_recurrence": lstm_recurrence, **TRAIN_KERNELS,
                     **BWD_KERNELS}
    _reset(train_kernels)
    losses = []
    for form, cw, n in (("grid", None, 5), ("cell", [0.0, 1.0], 2)):
        step = make_affinity_train_step(class_weights=cw, grid_loss=True)
        if step.grid_loss != (form == "grid"):
            raise RuntimeError(f"affinity {form} form: wrong step form")
        for i in range(n):
            batch = batches[len(losses) % len(batches)]
            # every step against the plain model's, as in ``_train``
            plain.load_flat(model.flat_params())
            plain.zero_grad(set_to_none=True)
            loss_p, want = affinity_loss(
                plain, table, batch, state.dropout_seeds(I),
                None if cw is None else torch.tensor(cw, device=dev),
                step.grid_loss)
            loss_p.backward()
            want = {k: v.detach() for k, v in want.items()}  # as there
            del loss_p
            how = _graph_path(step)
            metrics = step(state, table, batch)
            how = how(step)
            loss = metrics["loss"].item()
            losses.append(loss)
            print(f"affinity train step {state.step} ({form} form, {how}): "
                  f"loss {loss:.6f} acc {metrics['acc'].item():.4f}")
            if not np.isfinite(loss):
                raise RuntimeError(f"non-finite affinity loss at step "
                                   f"{state.step}")
            for k, v in want.items():
                check(f"affinity train {form} form step {i + 1} ({how}) {k}: "
                      f"kernel path vs plain", metrics[k], v)
            grads = dict(plain.named_parameters())
            errs = [check(f"affinity train {form} form step {i + 1} grad "
                          f"{k}", p.grad, grads[k].grad, quiet=True)
                    for k, p in model.named_parameters()]
            print(f"check affinity train {form} form step {i + 1} ({how}): "
                  f"{len(errs)} parameter gradients, kernel path vs plain, "
                  f"max|d| {max(e for e, _ in errs):.3e} (smallest gate "
                  f"{min(t for _, t in errs):.1e})")
    launches.update({k: launches.get(k, 0) + n for k, n in
                     _read(train_kernels, "affinity training").items()})
    print(f"affinity train: losses {[round(x, 6) for x in losses]}")

    # per-step times of both paths on the fullest batch, grid loss
    step = make_affinity_train_step(grid_loss=True)
    plain_state = create_train_state(plain, params=model.flat_params())
    per_unit["affinity train step"] = _replay_counts(
        step, state, table, batches[0], train_kernels,
        "one affinity train step, grid loss")
    profiles = [_profile("affinity train step, grid loss, kernel path",
                         lambda: step(state, table, batches[0])),
                _profile("affinity predict with ranking, kernel path, the "
                         "fullest batch",
                         lambda: affinity_predict(model, table, batches[0],
                                                  rank=True))]
    # the same in bf16 (the boxes already bf16, as the CLI copies them)
    bf = AffinityModel(**AFF_DIMS, fused=True, device=dev,
                       compute_dtype=torch.bfloat16)
    bf.load_flat(model.flat_params())
    bf_table = table.bfloat16()
    bf_batch = {**batches[0], "box_feats": batches[0]["box_feats"].bfloat16()}
    profiles.append(_profile(
        "affinity predict with ranking, kernel path, the fullest batch, "
        "--compute_dtype bf16",
        lambda: affinity_predict(bf, bf_table, bf_batch, rank=True)))
    step_ms = {}
    for name, st in (("kernel", state), ("plain", plain_state)):
        for _ in range(2):      # a new state's eager step, then its capture
            step(st, table, batches[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step(st, table, batches[0])
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t0) / 5 * 1e3
    return {"launches": launches, "shape": shape, "per_unit": per_unit,
            "profiles": profiles,
            "cells_per_s": cells / t_k, "plain_cells_per_s": cells / t_p,
            "predict_ms": t_k / len(batches) * 1e3,
            "plain_predict_ms": t_p / len(batches) * 1e3,
            "step_ms": step_ms["kernel"],
            "plain_step_ms": step_ms["plain"]}


class _Said(logging.Handler):
    """Keeps what the package logs while a command line runs."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def numbers(self, pattern: str) -> list:
        """The first group of ``pattern`` in every line it matches."""
        return [float(m.group(1)) for m in
                (re.search(pattern, line) for line in self.lines) if m]


def _staging(dev) -> None:
    """Phase 8b: the batches of reused, dirtied pinned slabs against fresh
    zeros copied array by array, on the device and through the graphed
    train step; raises on any difference."""
    pool = staging.POOL
    with tempfile.TemporaryDirectory(prefix="icl_chip_staging_") as d:
        generate_dataset(d, "train", SynthConfig(
            planted=True, emb_dim=DIMS["emb_dim"], vocab_size=VOCAB,
            max_caption_len=32, max_mentions_per_caption=3,
            max_boxes_per_image=20, num_images=128, seed=SEED))
        _widen_boxes(f"{d}/train.boxes.npz", AFF_DIMS["box_dim"], SEED)
        emb = EmbeddingStore.load(f"{d}/embeddings.txt")
        sets = {"relation": (RelationBatcher(images_per_batch=64,
                                             with_ids=False),
                             load_relation_dataset(d, "train", emb)),
                "affinity": (AffinityBatcher(
                    images_per_batch=64, mention_spec=BucketSpec((8, 16, 32)),
                    box_spec=BucketSpec((8, 16, 32)), phrase_len=16,
                    with_ids=False),
                    load_affinity_dataset(d, "train", emb))}

    def epoch(task):
        batcher, ds = sets[task]
        return [b.arrays for b in batcher.batches(
            ds, rng=np.random.default_rng(SEED))]

    pool.engaged = False
    fresh = {task: epoch(task) for task in sets}
    if any(pool.find(a) for a in fresh["affinity"] + fresh["relation"]):
        raise RuntimeError("staging: a batch padded into a slab while the "
                           "pool was off")
    pool.engage()
    for task in sets:
        epoch(task)                     # the slabs, dropped at once
    torch.cuda.synchronize()
    if not all(s.idle() for s in pool._slabs):
        raise RuntimeError("staging: a slab is busy with no batch alive")
    for s in pool._slabs:
        s.buf.fill_(0xFF)
    slab = {task: epoch(task) for task in sets}
    feeds = {}
    for task in sets:
        arrays = {"slab": [], "array": []}
        for a, b in zip(fresh[task], slab[task], strict=True):
            found = pool.find(b)
            if found is None or found[1].keys() != b.keys():
                raise RuntimeError(f"staging: a {task} batch is not in one "
                                   f"slab")
            got = staging.stage(b, dev)
            want = {k: torch.from_numpy(v).to(dev) for k, v in a.items()}
            base = got[next(iter(got))].untyped_storage().data_ptr()
            for k, w in want.items():
                g = got[k]
                if (g.shape != w.shape or g.dtype != w.dtype
                        or not g.is_contiguous()
                        or g.untyped_storage().data_ptr() != base
                        or (g.data_ptr() - base) % staging.ALIGN
                        or g.cpu().numpy().tobytes()
                        != w.cpu().numpy().tobytes()):
                    raise RuntimeError(f"staging: {task} field {k} from the "
                                       f"slab differs from fresh zeros")
            arrays["slab"].append(got)
            arrays["array"].append(want)
        feeds[task] = arrays
        print(f"check staging {task}: {len(slab[task])} batches from reused "
              f"0xFF slabs, each in one copy, bit-equal to fresh zeros "
              f"copied array by array")
    print(f"staging: {len(pool._slabs)} slabs, {pool.bytes / 2**20:.0f} MiB "
          f"pinned")
    del slab, fresh

    table = torch.from_numpy(emb.table).to(dev)
    models = {"relation": (lambda: RelationModel(
                  **DIMS, fused=True, dropout=RATE, device=dev),
                  lambda: make_relation_train_step(
                      class_weights=[0.3, 1.0, 1.0, 1.0], grid_loss=True)),
              "affinity": (lambda: AffinityModel(
                  **AFF_DIMS, fused=True, dropout=RATE, device=dev),
                  lambda: make_affinity_train_step(grid_loss=True))}
    for task, (make_model, make_step) in models.items():
        flat = make_model().flat_params()
        losses = {}
        for feed, batches in feeds[task].items():
            state = create_train_state(make_model(), seed=SEED, params=flat)
            step = make_step()
            order = [0, 1, 0, 1, 0] if len(batches) > 1 else [0] * 4
            losses[feed] = [step(state, table, batches[i])["loss"].item()
                            for i in order]
        if losses["slab"] != losses["array"]:
            raise RuntimeError(f"staging: {task} train losses from the slabs "
                               f"{losses['slab']} differ from "
                               f"{losses['array']}")
        print(f"check staging {task} graphed train step: losses "
              f"{[round(x, 6) for x in losses['slab']]} equal on both feeds")


def _same_checkpoint(a: dict, b: dict) -> list:
    """The entries in which two checkpoint payloads differ."""
    diff = [k for k in ("step", "seed", "epoch", "batch_in_epoch")
            if a[k] != b[k]]
    for part in ("model", "optimizer"):
        flat = [{}, {}]
        for out, tree in zip(flat, (a[part], b[part])):
            stack = [(part, tree)]
            while stack:
                name, t = stack.pop()
                if isinstance(t, dict):
                    stack += [(f"{name}/{k}", v) for k, v in t.items()]
                elif isinstance(t, (list, tuple)):
                    stack += [(f"{name}/{i}", v) for i, v in enumerate(t)]
                else:
                    out[name] = t
        diff += [k for k in sorted(set(flat[0]) | set(flat[1]))
                 if k not in flat[0] or k not in flat[1] or not (
                     torch.equal(flat[0][k], flat[1][k])
                     if isinstance(flat[0][k], torch.Tensor)
                     else flat[0][k] == flat[1][k])]
    return diff


def _cli(d: str) -> dict:
    """The two command lines on the card at full width, over a planted
    split on disk (written into ``d``, which the two-rank phase reads
    again): train, resume from a periodic checkpoint, predict twice; counts
    the launches of the whole phase."""
    kernels = {**PREDICT_KERNELS, **TRAIN_KERNELS,
               "affinity_rank": affinity_rank}
    needed = ("grid_head", "lstm_recurrence", "grid_head_train_loss_fwd",
              "grid_head_train_loss_bwd", "affinity_rank")
    said = _Said()
    logger = logging.getLogger("icl")
    logger.addHandler(said)
    times, per_unit = [], {}
    accuracy = {}       # task -> dev accuracy of the f32 model, percent
    _reset(kernels)
    try:
        # the split that kernel_bits.trained_batches batches for the
        # trained rows of phase 12
        for split, n in (("train", kernel_bits.PHASE9_TRAIN_IMAGES),
                         ("dev", 32)):
            generate_dataset(d, split, SynthConfig(
                num_images=n, seed=SEED + (split == "dev"),
                **kernel_bits.PHASE9_SPLIT))
            _widen_boxes(f"{d}/{split}.boxes.npz", AFF_DIMS["box_dim"],
                         SEED)
        emb = EmbeddingStore.load(f"{d}/embeddings.txt")
        for task, main_fn, unit in (("relation", relation_cli.main,
                                     "pairs"),
                                    ("affinity", affinity_cli.main,
                                     "cells")):
            common = ["--data_dir", d, "--device", "cuda",
                      "--images_per_batch", "64", "--seed", str(SEED),
                      *HIGHEST]
            train = ["--train", "--ckpt_every", "4", "--eval_every", "5",
                     *common]

            def run(what, argv):
                """One command line: its log lines and wall clock; what it
                printed is printed, and kept in `printed`."""
                said.lines.clear()
                before = {k: fn.launches for k, fn in kernels.items()}
                t0 = time.perf_counter()
                printed[0] = _captured(main_fn, argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                print(printed[0], end="")
                per_unit[f"icl-torch-{task} {what}"] = {
                    k: fn.launches - before[k]
                    for k, fn in kernels.items()}
                return wall

            printed = [""]
            # an uninterrupted run, and one stopped half way whose end
            # marker is deleted: it resumes from a periodic checkpoint.
            # (The dev loss need not fall: the planted relation rule is
            # learnt word by word, and 128 images show few of the 2000.)
            whole, cut = f"{d}/{task}.whole", f"{d}/{task}.cut"
            wall = run("--train", [*train, "--epochs", "10",
                                   "--model_file", whole, "--metrics_file",
                                   f"{d}/{task}.jsonl"])
            steps_s = said.numbers(r"training loop: .*\((\S+) steps/s\)")
            n_steps = said.numbers(r"training loop: (\d+) steps")
            stalls = said.numbers(r"loop stalled (\d+) ms")
            rows = [json.loads(line) for line in open(f"{d}/{task}.jsonl")]
            ex_s = [r["examples_per_sec"] for r in rows
                    if "examples_per_sec" in r]
            evals = [r for r in rows if "eval_loss" in r]
            if not (steps_s and ex_s and evals and stalls
                    and all(np.isfinite(r["eval_loss"]) for r in evals)
                    and all(np.isfinite(r["loss"]) for r in rows
                            if "loss" in r)):
                raise RuntimeError(f"icl-torch-{task} --train: bad "
                                   f"metrics {rows}")
            times.append(
                f"icl-torch-{task} --train [10 epochs of 128 images, "
                f"64 a batch, eval every 5 and checkpoint every 4 "
                f"steps]: {int(n_steps[0])} steps at {steps_s[0]:.2f} "
                f"steps/s in the loop, {ex_s[-1]:.0f} {unit}/s at its "
                f"last log, {np.mean(stalls):.1f} ms the loop stalled "
                f"per checkpoint save (max {max(stalls):.0f}, "
                f"{len(stalls)} saves), eval loss {evals[0]['eval_loss']:.4f}"
                f" -> {evals[-1]['eval_loss']:.4f}; the command "
                f"{wall:.2f} s")
            run("--train, first half", [*train, "--epochs", "5",
                                        "--model_file", cut])
            steps = sorted(int(n[5:-3]) for n in os.listdir(cut)
                           if n.startswith("step_"))
            os.unlink(f"{cut}/step_{steps[-1]}.pt")       # the marker
            start = torch.load(f"{cut}/step_{steps[-2]}.pt",
                               weights_only=True)
            if steps[-2] % 4 or start["epoch"] >= 5:
                raise RuntimeError(f"icl-torch-{task}: step {steps[-2]} "
                                   f"is no periodic checkpoint")
            wall = run("--train --resume auto",
                       [*train, "--epochs", "10", "--resume", "auto",
                        "--model_file", cut])
            steps_s = said.numbers(r"training loop: .*\((\S+) steps/s\)")
            ends = [torch.load(f"{m}/step_{int(n_steps[0])}.pt",
                               weights_only=True) for m in (whole, cut)]
            diff = _same_checkpoint(*ends)
            print(f"check icl-torch-{task} --resume auto from step "
                  f"{steps[-2]} (epoch {start['epoch']}, batch "
                  f"{start['batch_in_epoch']}) to step {ends[1]['step']}: "
                  f"weights and Adam state against the uninterrupted "
                  f"run's, bit for bit: "
                  f"{'ok' if not diff else 'FAIL ' + str(diff[:5])}")
            if diff:
                raise RuntimeError(f"icl-torch-{task}: the resumed run "
                                   f"differs in {diff[:5]}")
            times.append(f"icl-torch-{task} --train --resume auto [from "
                         f"step {steps[-2]}]: {steps_s[0]:.2f} steps/s "
                         f"in the loop; the command {wall:.2f} s")

            # predict twice: same bytes, dataset order, ranking rows
            outs = []
            for k in (1, 2):
                argv = ["--predict", "--eval", "--data_split", "dev",
                        *common, "--model_file", whole, "--scores_file",
                        f"{d}/{task}.{k}.scores"]
                if task == "affinity":
                    argv += ["--rank_file", f"{d}/{task}.{k}.rank"]
                wall = run("--predict", argv)
                accuracy[task] = _accuracy(printed[0])
                rate = said.numbers(rf"predict sweep: .*\((\d+) {unit}/s\)")
                count = said.numbers(rf"predict sweep: (\d+) {unit}")
                times.append(
                    f"icl-torch-{task} --predict --eval"
                    f"{' --rank_file' if task == 'affinity' else ''} "
                    f"[dev, 32 images, run {k}]: {int(count[0])} {unit} "
                    f"at {rate[0]:.0f} {unit}/s in the sweep; the "
                    f"command {wall:.2f} s")
                outs.append(open(f"{d}/{task}.{k}.scores", "rb").read())
            ids, probs = read_scores(f"{d}/{task}.1.scores")
            if task == "relation":
                ds = load_relation_dataset(d, "dev", emb)
                order = [pid for im in ds.images for pid in im.pair_ids]
            else:
                ds = load_affinity_dataset(d, "dev", emb)
                order = [im.cell_id(*parse_mention_id(mid)[1:], bi)
                         for im in ds.images
                         for r, mid in enumerate(im.mention_ids)
                         for c, bi in enumerate(im.box_idx)
                         if im.grid_valid[r, c]]
            ok = (outs[0] == outs[1] and ids == order and len(ids) > 1000
                  and bool(np.isfinite(probs).all())
                  and float(np.abs(probs.sum(1) - 1).max()) <= 2e-6)
            print(f"check icl-torch-{task} --predict: two runs "
                  f"byte-identical, {len(ids)} ids in dataset order, "
                  f"probs finite and summing to 1: "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"icl-torch-{task} --predict: bad "
                                   f".scores")
            if task == "affinity":
                if open(f"{d}/{task}.1.rank", "rb").read() != open(
                        f"{d}/{task}.2.rank", "rb").read():
                    raise RuntimeError("the two rank files differ")
                rids, rank = read_scores(f"{d}/{task}.1.rank")
                rows = {}
                for cid, p in zip(rids, rank[:, 0]):
                    rows.setdefault(cid.rsplit(";box:", 1)[0],
                                    []).append(p)
                off = max(abs(sum(v) - 1) for v in rows.values())
                print(f"check icl-torch-affinity --rank_file: "
                      f"{len(rows)} mentions, each row sums to 1 over "
                      f"its valid boxes within {off:.1e} (gate 2e-5: 6 "
                      f"decimals a box, up to 20 boxes): "
                      f"{'ok' if off <= 2e-5 and rids == ids else 'FAIL'}")
                if off > 2e-5 or rids != ids:
                    raise RuntimeError("bad rank file")
    finally:
        logger.removeHandler(said)
    launches = _count(kernels, "the command lines")
    missing = [k for k in needed if launches[k] < 1]
    if missing:
        raise RuntimeError(f"not launched from the command lines: {missing}")
    return {"launches": launches, "per_unit": per_unit, "times": times,
            "accuracy": accuracy}


def _bf16(dev, check, cli_dir: str, men_dir: str, f32_accuracy: dict) -> dict:
    """Phase 10b, ``--compute_dtype bf16``: the kernels' bf16 modes against
    their plain versions on the card, each twice with equal bits; then
    relation and affinity trained in bf16 through their CLIs on phase 9's
    split, predicted in bf16 and in f32 from that checkpoint, and the joint
    run in bf16 over phase 10's model dirs; counts what each command line
    launches."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    failures = []

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def head(G, A, B, K, O):
        return (rnd(G, A, K), rnd(G, B, K), rnd(K), rnd(K, O) / K ** 0.5,
                rnd(O))

    def rec(G, L, B, H):
        lengths = torch.randint(0, L + 1, (B,), generator=gen, device=dev)
        lengths[0], lengths[-1] = 0, L
        t = torch.arange(L, device=dev)[:, None]
        mask = torch.stack([t < lengths, (L - 1 - t) < lengths])[:G]
        return (rnd(G, L, B, 4 * H).bfloat16(), mask.contiguous(),
                (rnd(G, H, 4 * H) / H ** 0.5).bfloat16())

    def check_ulps(what, got, want, gate=BF16_REC_ULPS):
        """max |kernel - plain| of each tensor within `gate` bf16 units of
        its max |plain|; returns the worst in units."""
        worst = kernel_bits.bf16_units(want, got)
        ok = worst <= gate and all(bool(torch.isfinite(g).all())
                                   for g in got)
        print(f"check {what}: max|d| {worst:.2f} bf16 units of max|plain| "
              f"(gate {gate}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(what)

    def twice(what, fn, args):
        got = fn(*args)
        if not all(torch.equal(a, b)
                   for a, b in zip(_tuple(got), _tuple(fn(*args)))):
            failures.append(f"{what} not repeatable")
        return got

    # the fast-dot grid head (K1/K2): the relation and affinity batch
    # shapes, ragged tiles, K % 4 != 0, O = 8, and unaligned operands (the
    # scalar form)
    for G, A, B, K, O, moved in ((64, 16, 16, 800, 4, None),
                                 (64, 16, 32, 1024, 2, None),
                                 (2, 9, 17, 800, 3, None),
                                 (1, 17, 20, 1024, 4, None),
                                 (2, 7, 9, 50, 2, None),
                                 (2, 20, 33, 50, 8, None),
                                 (8, 16, 16, 800, 4, 1),
                                 (4, 16, 20, 1024, 2, 0)):
        args = list(head(G, A, B, K, O))
        want = grid_head_reference(*args, fast_dot=True)
        if moved is not None:
            args[moved] = _offset_view(args[moved])
        what = (f"grid_head bf16 fast dot G={G} A={A} B={B} K={K} O={O}"
                + (f", operand {moved} unaligned" if moved is not None
                   else "") + ", twice")
        check(what, twice(what, lambda *a: grid_head(*a, fast_dot=True),
                          args), want)
    # each form of the fast dot forced where dot_plan would pick the other:
    # the tensor cores at small grids and their edges (K % 16 != 0, B <= 8,
    # O odd, unaligned, more box tiles than a block's 8), the FMA form at a
    # batch
    for G, A, B, K, O, moved, mma in ((64, 16, 16, 792, 4, None, True),
                                      (3, 9, 6, 72, 3, None, True),
                                      (2, 20, 140, 50, 8, None, True),
                                      (8, 16, 16, 800, 4, 1, True),
                                      (64, 16, 16, 800, 4, None, False)):
        args = list(head(G, A, B, K, O))
        want = grid_head_reference(*args, fast_dot=True)
        if moved is not None:
            args[moved] = _offset_view(args[moved])

        def forced(*a, mma=mma, shape=(G, A, B, O)):
            out = torch.empty(shape, device=dev)
            gh_ops._fast_dot(*a, out, mma)
            return out
        what = (f"grid_head bf16 fast dot, {'tensor cores' if mma else 'FMA'}"
                f" form forced, G={G} A={A} B={B} K={K} O={O}"
                + (f", operand {moved} unaligned" if moved is not None
                   else "") + ", twice")
        check(what, twice(what, forced, args), want)
    # the box ranking (K9) over the fast-dot logits, ragged validity
    for G, moved in ((4, None), (64, None), (4, 1)):
        valid = torch.rand(G, 32, generator=gen, device=dev) < 0.7
        valid[:, 0] = True
        valid[-1] = False
        args = [*head(G, 16, 32, AFF_DIMS["head_hidden"], 2), valid]
        want = affinity_rank_reference(*args, 1, True)
        if moved is not None:
            args[moved] = _offset_view(args[moved])
        what = (f"affinity_rank bf16 fast dot G={G} A=16 B=32 K="
                f"{AFF_DIMS['head_hidden']}" + (
                    f", operand {moved} unaligned" if moved is not None
                    else "") + ", twice")
        got = twice(what, lambda *a: affinity_rank(*a, fast_dot=True), args)
        check(what, got, want)
        if got[~valid[:, None, :].expand_as(got)].any():
            failures.append(f"{what}: an invalid box not 0")
    # the bf16 recurrence: the relation batch (both directions, B = 64 and
    # 320), the phrase LSTM (G = 1, B = 1024), odd widths, one k-step (H =
    # 16), both sides of 368 (where the f32 mode's 16-block layout stops
    # holding R on chip) and 512, one row, one step; hs and h_final, and
    # with the residuals (which must not change hs)
    for G, L, B, H in ((2, 32, 64, 200), (2, 32, 320, 200),
                       (1, 16, 1024, 200), (2, 16, 61, 63), (1, 8, 9, 255),
                       (2, 16, 61, 300), (1, 8, 9, 511), (2, 8, 9, 16),
                       (2, 16, 17, 368), (2, 16, 17, 369), (2, 16, 61, 512),
                       (2, 8, 1, 200), (2, 1, 64, 200)):
        args = rec(G, L, B, H)
        what = f"lstm_recurrence bf16 G={G} L={L} B={B} H={H}"
        got = twice(what, lambda *a: lstm_recurrence_fwd(*a, residuals=True),
                    args)
        bare = lstm_recurrence_fwd(*args)
        if not (torch.equal(got[0], bare[0]) and torch.equal(got[1],
                                                              bare[1])):
            failures.append(f"{what}: the residuals changed hs")
        if any(t.dtype != torch.bfloat16 for t in got):
            failures.append(f"{what}: not bf16 out")
        check_ulps(f"{what} (hs, final, gates, c), twice", got,
                   lstm_recurrence_reference(*args, True))
    # its backward's bf16 mode on those residuals: the relation and
    # affinity train shapes, past 256 units, a narrow ragged H
    for G, L, B, H in ((2, 32, 320, 200), (1, 16, 1024, 200),
                       (2, 16, 61, 300), (2, 16, 61, 512), (2, 8, 13, 9)):
        args = rec(G, L, B, H)
        hs, _, gates, c = lstm_recurrence_fwd(*args, residuals=True)
        bwd = (gates, c, hs, args[2], args[1], rnd(G, L, B, H).bfloat16(),
               rnd(G, B, H).bfloat16())
        what = f"lstm_recurrence_bwd bf16 G={G} L={L} B={B} H={H}"
        got = twice(what, lstm_recurrence_bwd_kernel, bwd)
        check_ulps(f"{what} (dx_proj, dR), twice", got,
                   lstm_recurrence_bwd(*bwd), BF16_BWD_ULPS)
    if failures:
        raise RuntimeError(f"bf16 kernel checks failed: {failures}")

    # the command lines on phase 9's split
    kernels = {**PREDICT_KERNELS, **TRAIN_KERNELS,
               "affinity_rank": affinity_rank, **BF16_KERNELS,
               "lstm_recurrence_bwd_bf16": lstm_recurrence.bwd_bf16}
    said = _Said()
    logger = logging.getLogger("icl")
    logger.addHandler(said)
    d = cli_dir
    times, per_unit = [], {}
    _reset(kernels)
    try:
        for task, main_fn, unit in (("relation", relation_cli.main, "pairs"),
                                    ("affinity", affinity_cli.main,
                                     "cells")):
            common = ["--data_dir", d, "--device", "cuda",
                      "--images_per_batch", "64", "--seed", str(SEED),
                      *HIGHEST]
            model_dir = f"{d}/{task}.bf16"

            def run(what, argv, need, never):
                """One command line; the kernels in `need` must launch from
                it, those in `never` must not.  Returns its wall clock and
                what it printed."""
                said.lines.clear()
                before = {k: fn.launches for k, fn in kernels.items()}
                t0 = time.perf_counter()
                out = _captured(main_fn, argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                print(out, end="")
                n = {k: fn.launches - before[k] for k, fn in kernels.items()}
                per_unit[f"icl-torch-{task} {what}"] = n
                bad = [k for k in need if n[k] < 1] + [
                    k for k in never if n[k] > 0]
                print(f"check icl-torch-{task} {what}: launched "
                      f"{[k for k in need]}, not {[k for k in never]}: "
                      f"{'ok' if not bad else 'FAIL ' + str(bad)}")
                if bad:
                    raise RuntimeError(f"icl-torch-{task} {what}: launches "
                                       f"{n}")
                return wall, out

            wall, _ = run(
                "--train --compute_dtype bf16",
                ["--train", "--ckpt_every", "4", "--eval_every", "5",
                 *common, "--epochs", "10", "--model_file", model_dir,
                 "--compute_dtype", "bf16", "--metrics_file",
                 f"{d}/{task}.bf16.jsonl"],
                ("lstm_recurrence_bf16", "grid_head_train_loss_fwd",
                 "grid_head_train_loss_bwd", "grid_head_bf16dot",
                 "lstm_recurrence_bwd_bf16"),
                ("lstm_recurrence", "grid_head"))
            steps_s = said.numbers(r"training loop: .*\((\S+) steps/s\)")
            rows = [json.loads(ln) for ln in open(f"{d}/{task}.bf16.jsonl")]
            if not all(np.isfinite(r[k]) for r in rows
                       for k in ("loss", "eval_loss") if k in r):
                raise RuntimeError(f"icl-torch-{task} bf16: a loss is not "
                                   f"finite: {rows}")
            mc = json.load(open(f"{model_dir}/model_config.json"))
            end = torch.load(f"{model_dir}/step_"
                             f"{Checkpointer(model_dir).latest_step}.pt",
                             weights_only=True)
            if mc["compute_dtype"] != "bf16" or any(
                    v.dtype != torch.float32 for v in end["model"].values()):
                raise RuntimeError(f"icl-torch-{task} bf16: model_config "
                                   f"{mc} or non-f32 parameters")
            times.append(f"icl-torch-{task} --train --compute_dtype bf16 "
                         f"[10 epochs of 128 images, 64 a batch]: "
                         f"{steps_s[0]:.2f} steps/s in the loop; the command "
                         f"{wall:.2f} s")
            probs, acc = {}, {}
            for dtype in ("bf16", "f32"):
                scores = f"{d}/{task}.bf16.{dtype}.scores"
                argv = ["--predict", "--eval", "--data_split", "dev",
                        *common, "--model_file", model_dir, "--scores_file",
                        scores, "--compute_dtype", dtype]
                if task == "affinity":
                    argv += ["--rank_file", f"{d}/{task}.bf16.{dtype}.rank"]
                f32_ids = ("grid_head", "lstm_recurrence", "affinity_rank")
                bf16_ids = tuple(BF16_KERNELS)
                if task == "relation":
                    f32_ids, bf16_ids = f32_ids[:2], bf16_ids[:2]
                wall, out = run(
                    f"--predict --eval --compute_dtype {dtype}", argv,
                    *((bf16_ids, f32_ids) if dtype == "bf16"
                      else (f32_ids, bf16_ids)))
                acc[dtype] = _accuracy(out)
                ids, probs[dtype] = read_scores(scores)
                rate = said.numbers(rf"predict sweep: .*\((\d+) {unit}/s\)")
                times.append(f"icl-torch-{task} --predict --eval "
                             f"--compute_dtype {dtype} [dev, 32 images, the "
                             f"bf16-trained model]: {rate[0]:.0f} {unit}/s "
                             f"in the sweep; the command {wall:.2f} s")
                if task == "affinity":
                    rids, rank = read_scores(f"{d}/{task}.bf16.{dtype}.rank")
                    rows = {}
                    for cid, p in zip(rids, rank[:, 0]):
                        rows.setdefault(cid.rsplit(";box:", 1)[0],
                                        []).append(p)
                    off = max(abs(sum(v) - 1) for v in rows.values())
                    if off > 2e-5 or rids != ids:
                        raise RuntimeError(f"bf16 phase: bad rank file "
                                           f"({dtype}): {off}")
            # the fast dot at the batch users predict (the train split, 64
            # images a batch): its tensor-core entry points must take it
            fast = [grid_head.bf16dot] + (
                [affinity_rank.bf16dot] if task == "affinity" else [])
            before = [(f.launches, f.mma_launches) for f in fast]
            argv = ["--predict", "--data_split", "train", *common,
                    "--model_file", model_dir, "--scores_file",
                    f"{d}/{task}.bf16.train.scores", "--compute_dtype", "bf16"]
            if task == "affinity":
                argv += ["--rank_file", f"{d}/{task}.bf16.train.rank"]
            run("--predict --compute_dtype bf16 on the train split", argv,
                bf16_ids, f32_ids)
            took = [(f.launches - n, f.mma_launches - m)
                    for f, (n, m) in zip(fast, before)]
            names = ["icl_grid_head_bf16dot", "icl_affinity_rank_bf16dot"]
            ok = all(m > 0 for _, m in took)
            print(f"check icl-torch-{task} --predict --compute_dtype bf16 "
                  f"over 128 images, 64 a batch, at full width: " + ", ".join(
                      f"{name} on the tensor cores {m} of {n} launches"
                      for name, (n, m) in zip(names, took)) +
                  f": {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"icl-torch-{task} bf16 batch predict: "
                                   f"the fast dot never took the tensor "
                                   f"cores {took}")
            drift = float(np.abs(probs["bf16"] - probs["f32"]).max())
            gap = abs(acc["bf16"] - f32_accuracy[task])
            # the dev loss of the bf16 run at each eval against phase 9's
            # f32 run (same seed, flags and schedule)
            curves = [{r["step"]: r["eval_loss"]
                       for r in map(json.loads, open(f"{d}/{task}{s}.jsonl"))
                       if "eval_loss" in r} for s in ("", ".bf16")]
            curve = max(abs(curves[1][k] / v - 1) for k, v in
                        curves[0].items()) if curves[0].keys() == curves[
                            1].keys() else math.inf
            ok = (drift <= BF16_DRIFT and gap <= 4.0
                  and curve <= BF16_LOSS_CURVE
                  and bool(np.isfinite(probs["bf16"]).all()))
            print(f"check icl-torch-{task} --compute_dtype bf16: dev accuracy "
                  f"{acc['bf16']:.2f}% trained and predicted in bf16 against "
                  f"{f32_accuracy[task]:.2f}% in f32 (phase 9), gap "
                  f"{gap:.2f} points (gate 4), the dev split's majority "
                  f"class {_majority(out):.2f}%; dev loss at the "
                  f"{len(curves[0])} evals within {curve:.2e} of the f32 "
                  f"run's, relative (gate {BF16_LOSS_CURVE}; bf16 "
                  f"{[round(x, 4) for x in curves[1].values()]}); the bf16 "
                  f"checkpoint predicted in f32: {acc['f32']:.2f}%; bf16 vs "
                  f"f32 probabilities of that checkpoint max|d| {drift:.3e} "
                  f"(gate {BF16_DRIFT})"
                  f"{'; rank rows sum to 1' if task == 'affinity' else ''}: "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"icl-torch-{task} bf16: accuracy gap "
                                   f"{gap}, dev loss {curve} or drift "
                                   f"{drift}")

        # the reference's planted gate at full width, on a split whose rule
        # 96 images teach (tests/integration/test_convergence.py)
        pd = f"{d}/planted16"
        kw = dict(planted=True, emb_dim=DIMS["emb_dim"], vocab_size=16,
                  captions_per_image=3, max_mentions_per_caption=2,
                  max_boxes_per_image=4)
        for split, n in (("train", 96), ("dev", 24)):
            generate_dataset(pd, split, SynthConfig(num_images=n, seed=1,
                                                    **kw))
        acc, t0 = {}, time.perf_counter()
        for dtype in ("f32", "bf16"):
            common = ["--data_dir", pd, "--device", "cuda",
                      "--images_per_batch", "16", "--seed", "3",
                      "--compute_dtype", dtype, "--model_file",
                      f"{pd}/{dtype}.model", *HIGHEST]
            _captured(relation_cli.main, [
                "--train", "--epochs", "25", "--dropout", "0.0",
                "--learn_rate", "0.01", *common])
            out = _captured(relation_cli.main, [
                "--predict", "--eval", "--data_split", "dev",
                "--scores_file", f"{pd}/{dtype}.scores", *common])
            acc[dtype] = _accuracy(out)
        wall = time.perf_counter() - t0
        majority = _majority(out)
        ok = (acc["f32"] >= 93.0 and acc["bf16"] >= 90.0
              and abs(acc["f32"] - acc["bf16"]) <= 4.0)
        print(f"check icl-torch-relation planted gate at full width "
              f"(vocabulary 16, 96 train and 24 dev images, 25 epochs): dev "
              f"accuracy {acc['f32']:.2f}% in f32 (gate 93), "
              f"{acc['bf16']:.2f}% in bf16 (gate 90), gap "
              f"{abs(acc['f32'] - acc['bf16']):.2f} points (gate 4), the "
              f"majority class {majority:.2f}%: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"planted gate: {acc}")
        times.append(f"icl-torch-relation planted gate [two --train of 25 "
                     f"epochs of 96 images, 16 a batch, and two --predict "
                     f"--eval]: {wall:.2f} s")

        # the joint run in bf16 over phase 10's model dirs: the mention
        # tasks ignore the flag (their files keep the f32 run's bytes)
        wrote = {t: f"{men_dir}/dev.{t}.scores"
                 for t in ("nonvisual", "cardinality", "relation",
                           "affinity")}
        wrote["rank"] = f"{men_dir}/dev.affinity.rank"
        f32_files = {t: open(p, "rb").read() for t, p in wrote.items()}
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        with _flags_kept():
            joint_cli.main(["--predict", "--data_dir", men_dir, "--device",
                            "cuda", "--data_split", "dev",
                            "--images_per_batch", "64", "--batch_size",
                            str(MENTION_BATCH), "--seed", str(SEED),
                            "--with_cardinality", "--with_rank",
                            "--compute_dtype", "bf16"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {k: fn.launches - before[k] for k, fn in kernels.items()}
        per_unit["icl-torch-joint --compute_dtype bf16"] = n
        same = [t for t in ("nonvisual", "cardinality")
                if open(wrote[t], "rb").read() == f32_files[t]]
        drift = 0.0
        for t in ("relation", "affinity", "rank"):
            ids, p = read_scores(wrote[t])
            with tempfile.NamedTemporaryFile(suffix=".scores") as f:
                f.write(f32_files[t])
                f.flush()
                want_ids, q = read_scores(f.name)
            if ids != want_ids:
                raise RuntimeError(f"icl-torch-joint bf16: {t} ids differ")
            drift = max(drift, float(np.abs(p - q).max()))
        ok = (len(same) == 2 and drift <= BF16_DRIFT
              and min(n[k] for k in BF16_KERNELS) > 0
              and max(n[k] for k in ("grid_head", "lstm_recurrence",
                                     "affinity_rank")) == 0)
        print(f"check icl-torch-joint --compute_dtype bf16: the mention "
              f"tasks' files the f32 run's bytes ({same}), relation, "
              f"affinity and the ranking within {drift:.3e} of the f32 run "
              f"(gate {BF16_DRIFT}), launches {n}: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError("icl-torch-joint --compute_dtype bf16")
        times.append(f"icl-torch-joint --compute_dtype bf16 --with_cardinality"
                     f" --with_rank [dev, 275 images]: the command "
                     f"{wall:.2f} s")
    finally:
        logger.removeHandler(said)
    launches = _count(kernels, "the bf16 phase")
    return {"launches": launches, "per_unit": per_unit, "times": times}


def _onepass(dev, check, cli_dir: str, f32_units: dict) -> dict:
    """Phase 10c, ``--matmul_precision default``: the one-pass bf16 mode of
    K5-K8 against its plain versions on the card, each twice with equal
    bits; relation and affinity trained with no precision flag on phase
    9's split, held to phase 9's ``highest`` runs; the planted gate in
    ``default``.  ``f32_units``: phase 9's launches per command line."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    failures = []

    def inputs(G, A, B, K, O, density=0.75):
        """K5-K8's arguments (rate aside) over one random problem."""
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev)

        X, Y, b1, W2, b2 = (rnd(G, A, K), rnd(G, B, K), rnd(K),
                            rnd(K, O) / K ** 0.5, rnd(O))
        seeds = torch.randint(0, 2 ** 31 - 1, (G,), generator=gen,
                              device=dev, dtype=torch.int32)
        labels = torch.randint(0, O, (G, A, B), generator=gen, device=dev,
                               dtype=torch.int32)
        weights = ((torch.rand(G, A, B, generator=gen, device=dev) < density)
                   * torch.where(torch.rand(G, A, B, generator=gen,
                                            device=dev) > 0.5, 1.0, 0.3))
        return {"grid_head_train_fwd": (X, Y, b1, W2, b2, seeds),
                "grid_head_train_bwd": (X, Y, b1, W2, seeds,
                                        rnd(G, A, B, O)),
                "grid_head_train_loss_fwd": (X, Y, b1, W2, b2, seeds, labels,
                                             weights),
                "grid_head_train_loss_bwd": (X, Y, b1, W2, b2, seeds, labels,
                                             weights, torch.rand(
                                                 (), generator=gen,
                                                 device=dev))}

    plain_of = {"grid_head_train_fwd": ght.grid_head_train_reference,
                "grid_head_train_bwd": ght.grid_head_train_bwd_plain,
                "grid_head_train_loss_fwd": ght.grid_head_train_loss_reference,
                "grid_head_train_loss_bwd": ght.grid_head_train_loss_bwd_plain}
    # the relation and affinity batch shapes and the widest relation grid,
    # ragged tiles, K % 4 != 0, every head width, an unaligned Y (the
    # scalar form); K7/K8 at weight densities 0, 0.19 and 1; rates 0, 0.5
    worst, n_cases = 0.0, 0
    shapes = [(64, 16, 16, 800, 4, 0.75, None), (64, 32, 32, 800, 4, 0.75,
                                                   None),
              (64, 16, 32, 1024, 2, 0.75, None), (64, 16, 20, 1024, 2, 0.75,
                                                    None),
              (2, 9, 17, 800, 3, 0.75, None), (1, 5, 7, 30, 1, 0.75, None),
              (2, 20, 33, 50, 8, 0.75, None), (1, 17, 20, 1024, 4, 0.75,
                                                None),
              (8, 16, 16, 800, 4, 0.75, 1), (4, 16, 20, 1024, 2, 0.75, 1),
              (64, 16, 16, 800, 4, 0.0, None), (64, 16, 16, 800, 4, 0.19,
                                                 None),
              (64, 16, 16, 800, 4, 1.0, None), (8, 16, 32, 1024, 2, 0.0,
                                                None),
              (8, 16, 32, 1024, 2, 0.19, None), (8, 16, 32, 1024, 2, 1.0,
                                                 None)]
    for G, A, B, K, O, density, moved in shapes:
        cases = inputs(G, A, B, K, O, density)
        for rate in (0.0, RATE):
            for name, plain_args in cases.items():
                fn = TRAIN_KERNELS[name]
                a = list(plain_args)
                if moved is not None:
                    a[moved] = _offset_view(a[moved])
                # K8 in its two halves: its g3 against the plain g3, its
                # gradients against the plain backward of its own g3 (the
                # backward rounds g3 to bf16, and a g3 the logits' f32 sum
                # order moved by a unit may round to the neighbouring value)
                g3 = (torch.empty(G, A, B, O, device=dev)
                      if name == "grid_head_train_loss_bwd" else None)
                kw = {} if g3 is None else {"g3_out": g3}
                n0, n1 = fn.launches, fn.onepass.launches
                got = fn(*a, rate, False, **kw)
                again = fn(*a, rate, False, **kw)
                what = (f"{name} one-pass G={G} A={A} B={B} K={K} O={O} "
                        f"rate={rate} weight density {density}"
                        + (", Y unaligned" if moved is not None else ""))
                if g3 is None:
                    want = plain_of[name](*plain_args, rate, False)
                else:
                    X, Y, b1, W2, _, seeds = plain_args[:6]
                    err, tol = check(f"{what}: g3", g3,
                                     ght.grid_head_train_dlogits_plain(
                                         *plain_args, rate, False),
                                     quiet=True)
                    if not err <= tol:
                        failures.append(f"{what}: g3")
                    worst = max(worst, err / tol)
                    want = (*ght.grid_head_train_bwd_plain(
                        X, Y, b1, W2, seeds, g3, rate, False),
                        g3.sum((0, 1, 2)))
                if (fn.launches, fn.onepass.launches) != (n0, n1 + 2):
                    failures.append(f"{what}: launch counts")
                if not all(torch.equal(x, y) for x, y in
                           zip(_tuple(got), _tuple(again))):
                    failures.append(f"{what} not repeatable")
                if density == 0.0 and "loss" in name and any(
                        t.any() for t in _tuple(got)):
                    failures.append(f"{what}: not all zero")
                err, tol = check(what, got, want, quiet=True)
                if not err <= tol:
                    failures.append(what)
                worst = max(worst, err / tol)
                n_cases += 1
    print(f"check grid head K5-K8 one-pass bf16 against their plain "
          f"versions (exact=False; K8 in its two halves, on its own g3), "
          f"{n_cases} cases at the relation and "
          f"affinity shapes, ragged tiles, K % 4 != 0, O in 1..8, an "
          f"unaligned Y, weight densities 0-1, rates 0 and {RATE}, each "
          f"twice: worst max|d| {worst:.3f} of the gate "
          f"(1e-5 * max(1, max|plain|)), repeated bits equal, launches "
          f"counted as one-pass: {'ok' if not failures else 'FAIL'}")
    if failures:
        raise RuntimeError(f"one-pass kernel checks failed: {failures}")

    # the command lines on phase 9's split, no precision flag
    kernels = {**TRAIN_KERNELS, **ONEPASS_KERNELS}
    said = _Said()
    logger = logging.getLogger("icl")
    logger.addHandler(said)
    d = cli_dir
    times, per_unit = [], {}
    _reset(kernels)
    try:
        for task, main_fn in (("relation", relation_cli.main),
                              ("affinity", affinity_cli.main)):
            model_dir = f"{d}/{task}.default"
            before = {k: fn.launches for k, fn in kernels.items()}
            t0 = time.perf_counter()
            said.lines.clear()
            _captured(main_fn, [
                "--train", "--ckpt_every", "4", "--eval_every", "5",
                "--data_dir", d, "--device", "cuda", "--images_per_batch",
                "64", "--seed", str(SEED), "--epochs", "10", "--model_file",
                model_dir, "--metrics_file", f"{d}/{task}.default.jsonl"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = {k: fn.launches - before[k] for k, fn in kernels.items()}
            per_unit[f"icl-torch-{task} --train (default precision)"] = n
            f32 = f32_units[f"icl-torch-{task} --train"]
            steps_s = said.numbers(r"training loop: .*\((\S+) steps/s\)")
            cfg = json.load(open(f"{model_dir}/train_config.json"))
            # every step launches the one-pass K7 and K8; the dev evals the
            # exact K7 at rate 0, as phase 9's did (the reference pins its
            # eval kernel at highest); nothing else
            steps = f32["grid_head_train_loss_bwd"]
            evals = f32["grid_head_train_loss_fwd"] - steps
            want = {"grid_head_train_loss_fwd_onepass": steps,
                    "grid_head_train_loss_bwd_onepass": steps,
                    "grid_head_train_loss_fwd": evals}
            bad = {k: v for k, v in n.items() if v != want.get(k, 0)}
            curves = [{r["step"]: r["eval_loss"]
                       for r in map(json.loads, open(f"{d}/{task}{s}.jsonl"))
                       if "eval_loss" in r} for s in ("", ".default")]
            curve = max(abs(curves[1][k] / v - 1) for k, v in
                        curves[0].items()) if curves[0].keys() == curves[
                            1].keys() else math.inf
            rows = [json.loads(ln) for ln in open(f"{d}/{task}.default.jsonl")]
            finite = all(np.isfinite(r[k]) for r in rows
                         for k in ("loss", "eval_loss") if k in r)
            ok = (not bad and curve <= DEFAULT_LOSS_CURVE and finite
                  and (cfg["_matmul_precision"], cfg["_tf32"],
                       cfg["_head_exact"]) == ("default", True, False))
            print(f"check icl-torch-{task} --train with no precision flag "
                  f"(default: TF32, one-pass K7/K8) on phase 9's split: "
                  f"launches {n} ({steps} steps one-pass, {evals} dev-eval "
                  f"launches of the exact K7, no other training kernel); "
                  f"dev loss at the {len(curves[0])} evals within "
                  f"{curve:.2e} of the highest run's, relative (gate "
                  f"{DEFAULT_LOSS_CURVE}; default "
                  f"{[round(x, 4) for x in curves[1].values()]}, highest "
                  f"{[round(x, 4) for x in curves[0].values()]}); "
                  f"train_config.json {cfg['_matmul_precision']}, TF32 "
                  f"{cfg['_tf32']}, exact {cfg['_head_exact']}: "
                  f"{'ok' if ok else 'FAIL ' + str(bad)}")
            if not ok:
                raise RuntimeError(f"icl-torch-{task} --train in default "
                                   f"precision: launches {bad}, dev loss "
                                   f"{curve}, config {cfg}")
            times.append(f"icl-torch-{task} --train, no precision flag "
                         f"(default) [10 epochs of 128 images, 64 a batch]: "
                         f"{steps_s[0]:.2f} steps/s in the loop; the command "
                         f"{wall:.2f} s")

        # the pair form (a class weight of 0 turns the grid loss off): the
        # one-pass K5 and K6, no other training kernel
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        said.lines.clear()
        _captured(relation_cli.main, [
            "--train", "--null_weight", "0", "--data_dir", d, "--device",
            "cuda", "--images_per_batch", "64", "--seed", str(SEED),
            "--epochs", "2", "--model_file", f"{d}/relation.pair.default"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {k: fn.launches - before[k] for k, fn in kernels.items()}
        per_unit["icl-torch-relation --train --null_weight 0 (default "
                 "precision)"] = n
        steps = n["grid_head_train_fwd_onepass"]
        ok = (steps > 0 and n["grid_head_train_bwd_onepass"] == steps
              and not any(v for k, v in n.items()
                          if k not in ("grid_head_train_fwd_onepass",
                                       "grid_head_train_bwd_onepass")))
        print(f"check icl-torch-relation --train --null_weight 0 with no "
              f"precision flag (the pair form): launches {n}: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"the pair form in default precision: {n}")
        times.append(f"icl-torch-relation --train --null_weight 0, default "
                     f"precision [2 epochs of 128 images, the pair form]: "
                     f"the command {wall:.2f} s")

        # an LSTM wider than the 8-block cluster takes (256 units): the
        # recurrence kernel's 16-block cluster, and the grid-head kernels
        before = {k: fn.launches for k, fn in kernels.items()}
        rec0 = (lstm_recurrence.launches, lstm_recurrence.bf16.launches)
        said.lines.clear()
        _captured(relation_cli.main, [
            "--train", "--lstm_hidden_width", "300", "--data_dir", d,
            "--device", "cuda", "--images_per_batch", "64", "--seed",
            str(SEED), "--epochs", "1", "--model_file", f"{d}/relation.wide",
            "--metrics_file", f"{d}/relation.wide.jsonl"])
        torch.cuda.synchronize()
        n = {k: fn.launches - before[k] for k, fn in kernels.items()}
        per_unit["icl-torch-relation --train --lstm_hidden_width 300 "
                 "(default precision)"] = n
        warned = [ln for ln in said.lines if "--lstm_hidden_width 300" in ln]
        rows = [json.loads(ln) for ln in open(f"{d}/relation.wide.jsonl")]
        steps = n["grid_head_train_loss_bwd_onepass"]
        ok = (not warned and steps > 0
              and n["grid_head_train_loss_fwd_onepass"] == steps
              and lstm_recurrence.launches - rec0[0] >= steps
              and lstm_recurrence.bf16.launches == rec0[1]
              and all(np.isfinite(r["loss"]) for r in rows if "loss" in r))
        print(f"check icl-torch-relation --train --lstm_hidden_width 300 on "
              f"the card: warned {len(warned)} time(s), the recurrence "
              f"kernel launched {lstm_recurrence.launches - rec0[0]} times "
              f"for {steps} steps, the training grid head {n}, losses "
              f"finite: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"--lstm_hidden_width 300: {warned}, {n}")

        # the planted gate (tests/integration/test_convergence.py) in the
        # reference's default training precision, at full width on phase
        # 10b's vocabulary-16 split
        pd = f"{d}/planted16"
        common = ["--data_dir", pd, "--device", "cuda", "--images_per_batch",
                  "16", "--seed", "3", "--model_file", f"{pd}/default.model"]
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        _captured(relation_cli.main, ["--train", "--epochs", "25",
                                      "--dropout", "0.0", "--learn_rate",
                                      "0.01", *common])
        out = _captured(relation_cli.main, [
            "--predict", "--eval", "--data_split", "dev", "--scores_file",
            f"{pd}/default.scores", *common])
        wall = time.perf_counter() - t0
        n = {k: fn.launches - before[k] for k, fn in kernels.items()}
        per_unit["icl-torch-relation planted, default precision"] = n
        acc = _accuracy(out)
        ok = (acc >= PLANTED_GATE
              and n["grid_head_train_loss_bwd_onepass"] > 0
              and n["grid_head_train_loss_bwd"] == 0)
        print(f"check icl-torch-relation planted gate in default precision "
              f"(one-pass K7/K8, TF32; vocabulary 16, 96 train and 24 dev "
              f"images, 25 epochs): dev accuracy {acc:.2f}% (gate "
              f"{PLANTED_GATE:.0f}), the majority class {_majority(out):.2f}%"
              f", launches {n}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"planted gate in default precision: {acc}, "
                               f"{n}")
        times.append(f"icl-torch-relation planted gate, default precision "
                     f"[--train 25 epochs of 96 images, 16 a batch, and "
                     f"--predict --eval]: {wall:.2f} s")
    finally:
        logger.removeHandler(said)
    launches = _count(kernels, "the one-pass phase's command lines")
    print("launches of the one-pass entry points over phase 10c's command "
          "lines: " + ", ".join(f"{k} {launches[k]}"
                                for k in ONEPASS_KERNELS))

    # the relation train step in both precisions, in turns, on the fullest
    # batch of phase 9's split: where the device time goes
    emb = EmbeddingStore.load(f"{d}/embeddings.txt")
    table = torch.from_numpy(emb.table).to(dev)
    batch = max((b.arrays for b in RelationBatcher(
        images_per_batch=64, build_grid=True).batches(
            load_relation_dataset(d, "train", emb))),
        key=lambda a: int(a["pair_valid"].sum()))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    step = make_relation_train_step(class_weights=[0.3, 1.0, 1.0, 1.0],
                                    grid_loss=True)
    profiles = []
    for mode in ("highest", "default", "default", "highest"):
        prec = precision_policy(mode, "cuda", False)
        model = RelationModel(**DIMS, fused=True, dropout=RATE, device=dev,
                              exact=prec.head_exact)
        state = create_train_state(model, seed=SEED)
        with _flags_kept():
            torch.backends.cuda.matmul.allow_tf32 = prec.tf32
            torch.backends.cudnn.allow_tf32 = prec.tf32
            profiles.append(_profile(
                f"relation train step, grid loss, --matmul_precision {mode} "
                f"(TF32 {prec.tf32}, exact K5-K8 {prec.head_exact}) "
                f"[I={batch['tokens'].shape[0]}]",
                lambda s=state: step(s, table, batch)))
    return {"launches": launches, "per_unit": per_unit, "times": times,
            "profiles": profiles}


def _dataset_diff(a, b) -> list:
    """Where two loads of one split differ (the relation, affinity or
    mention dataset): field names, empty when equal in dtype and value."""
    if hasattr(a, "ids"):                   # a mention dataset
        out = [] if a.ids == b.ids else ["ids"]
        return out + [f for f in ("token_ids", "lengths", "labels")
                      if not _same_array(getattr(a, f), getattr(b, f))]
    if len(a.images) != len(b.images):
        return ["images"]
    out = set()
    for x, y in zip(a.images, b.images):
        for f, v in vars(x).items():
            w = getattr(y, f)
            if v is None or isinstance(v, (str, list, dict)):
                same = v == w
            else:               # arrays, and lazy views of the box rows
                same = _same_array(v, w)
            if not same:
                out.add(f)
    return sorted(out)


def _same_array(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@contextlib.contextmanager
def _python_io():
    """The port's pure-Python I/O paths: its native library as if it had
    not loaded."""
    keep = native._lib, native._load_failed
    native._lib, native._load_failed = None, True
    try:
        yield
    finally:
        native._lib, native._load_failed = keep


def _native_io(cli_dir: str, built: tuple) -> dict:
    """Phase 10d, the port's C++ I/O library (``icl_torch/native``): it
    must build or load; a split of Flickr30k's test size loads for
    relation, affinity and the mention tasks on the native path and on the
    Python path to equal datasets, the relation ``.scores`` write gives
    equal bytes both ways, each timed both ways (host clocks); relation
    ``--predict`` on phase 9's split prints its command wall clock beside
    its sweep clock both ways; ``--oracle-parity`` is refused at start-up
    where Keras cannot be imported, naming it.  ``built``: phase 2's
    (library, build seconds), 0.0 seconds when it came from the cache."""
    times = []
    cxx, version = native.compiler()
    path, secs = built
    print(f"native I/O library: {cxx} ({version or 'no version'}), "
          + (f"built in {secs:.1f} s" if secs else "taken from the cache")
          + f" -> {path.name}")
    if not native.available():
        raise RuntimeError("the native I/O library did not build or load")

    def both(what, fn):
        """fn() on the native path, then on the Python path: results and
        seconds."""
        t0 = time.perf_counter()
        fast = fn()
        t_native = time.perf_counter() - t0
        with _python_io():
            t0 = time.perf_counter()
            slow = fn()
            t_python = time.perf_counter() - t0
        times.append(f"{what}: native {t_native:.3f} s, Python "
                     f"{t_python:.3f} s ({t_python / t_native:.1f}x), "
                     f"host clock")
        return fast, slow

    with tempfile.TemporaryDirectory(prefix="icl_chip_native_") as d:
        # Flickr30k's test split: 1000 images, 5 captions each; the box
        # features stay narrow (no loader of this phase reads them whole)
        t0 = time.perf_counter()
        counts = generate_dataset(d, "test", SynthConfig(
            num_images=1000, captions_per_image=5, max_caption_len=32,
            max_mentions_per_caption=3, vocab_size=VOCAB,
            emb_dim=DIMS["emb_dim"], seed=SEED))
        print(f"native I/O split: {counts} written in "
              f"{time.perf_counter() - t0:.1f} s")
        emb = EmbeddingStore.load(f"{d}/embeddings.txt")
        words, py_words = both("split_vocab [1000 images]",
                               lambda: split_vocab(d, "test"))
        loads = {"relation": lambda: load_relation_dataset(d, "test", emb),
                 "affinity": lambda: load_affinity_dataset(d, "test", emb),
                 "mention": lambda: load_mention_dataset(d, "test",
                                                         "nonvisual", emb)}
        bad = [] if words == py_words else ["split_vocab"]
        rel = None
        for task, load in loads.items():
            fast, slow = both(f"load {task} dataset [1000 images]", load)
            diff = _dataset_diff(fast, slow)
            print(f"check load {task} dataset [1000 images]: native and "
                  f"Python paths equal: {'ok' if not diff else diff}")
            bad += [f"{task} {f}" for f in diff]
            rel = fast if task == "relation" else rel
        ids = [pid for im in rel.images for pid in im.pair_ids]
        probs = np.random.default_rng(SEED).dirichlet(np.ones(4), len(ids))
        out = [f"{d}/native.scores", f"{d}/python.scores"]
        both(f"write relation .scores [{len(ids)} pairs]",
             lambda: write_scores(out.pop(0), ids, probs))
        same = (open(f"{d}/native.scores", "rb").read()
                == open(f"{d}/python.scores", "rb").read())
        print(f"check write relation .scores [{len(ids)} pairs]: native and "
              f"Python bytes equal: {'ok' if same else 'FAIL'}")
        if not same:
            bad.append("scores bytes")
        if bad:
            raise RuntimeError(f"native and Python I/O differ: {bad}")

    # --predict's wall clock beside its sweep clock, both ways
    said = _Said()
    logger = logging.getLogger("icl")
    logger.addHandler(said)
    try:
        for way, ctx in (("native", contextlib.nullcontext),
                         ("Python", _python_io)):
            said.lines.clear()
            with ctx():
                t0 = time.perf_counter()
                _captured(relation_cli.main, [
                    "--predict", "--data_dir", cli_dir, "--data_split",
                    "dev", "--device", "cuda", "--images_per_batch", "64",
                    "--seed", str(SEED), *HIGHEST, "--model_file",
                    f"{cli_dir}/relation.whole", "--scores_file",
                    f"{cli_dir}/relation.io.scores"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            sweep = said.numbers(r"predict sweep: \d+ pairs in (\S+) s")
            times.append(f"icl-torch-relation --predict [phase 9's dev "
                         f"split, 32 images], {way} I/O: the command "
                         f"{wall:.2f} s, its sweep {sweep[0]:.2f} s")
    finally:
        logger.removeHandler(said)

    # --oracle-parity needs Keras: refused at start-up, before any data
    if importlib.util.find_spec("keras") is None:
        try:
            relation_cli.main(["--predict", "--data_dir",
                               f"{cli_dir}/absent", "--device", "cuda",
                               "--oracle-parity"])
            raise RuntimeError("--oracle-parity ran without Keras")
        except RefusedFlagError as e:
            ok = "Keras" in str(e) and "--oracle-parity" in str(e)
            print(f"check --oracle-parity without Keras refused at "
                  f"start-up: {e}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"bad refusal: {e}") from e
    else:
        print("keras is importable here: the start-up refusal is not "
              "checked")
    return {"times": times}


@contextlib.contextmanager
def _flags_kept():
    """Restores the matmul flags a command line sets (its
    ``--matmul_precision``), so a ``default`` run leaves no TF32 behind for
    the plain GEMMs of later phases."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
         ) = keep


def _captured(main_fn, argv) -> str:
    """What one command line prints on its standard output; the matmul
    flags are as they were before it."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), _flags_kept():
        main_fn(argv)
    return buf.getvalue()


def _accuracy_line(table: str) -> str:
    """The ``Accuracy: ...`` line of a ScoreDict table."""
    lines = [ln for ln in table.splitlines() if ln.startswith("Accuracy:")]
    if len(lines) != 1:
        raise RuntimeError(f"no accuracy line in {table!r}")
    return lines[0]


def _accuracy(table: str) -> float:
    """The dev accuracy, in percent, of a ScoreDict table."""
    return float(re.search(r"Accuracy: (\S+)%", _accuracy_line(table))
                 .group(1))


def _majority(table: str) -> float:
    """The accuracy, in percent, of always answering the commonest gold
    label of a ScoreDict table."""
    gold = [int(n) for n in re.findall(r"\|\s*(\d+) \(\s*[\d.]+%\)$", table,
                                       re.M)]
    return 100.0 * max(gold) / sum(gold)


def _mention_request(rng, k: int) -> dict:
    """64 mentions of 1..3 tokens; every tenth has an unknown word."""
    mentions = []
    for r in range(64):
        toks = [f"w{int(t):03d}" for t in
                rng.integers(0, MENTION_VOCAB, int(rng.integers(1, 4)))]
        if r % 10 == 9:
            toks.append("nosuchword")
        mentions.append({"id": f"q{k}m{r}", "tokens": toks})
    return {"mentions": mentions}


def _mention(d: str) -> dict:
    """The two mention tasks on the card at full width (train, resume,
    predict, export and import, their endpoints), then the joint run over
    all four tasks, in ``d``; counts what the joint run launches."""
    kernels = {**PREDICT_KERNELS, **TRAIN_KERNELS,
               "affinity_rank": affinity_rank}
    joint_kernels = {**PREDICT_KERNELS, "affinity_rank": affinity_rank}
    tasks = {"nonvisual": (nonvisual_cli.main, NonvisualModel),
             "cardinality": (cardinality_cli.main, CardinalityModel)}
    said = _Said()
    logger = logging.getLogger("icl")
    logger.addHandler(said)
    times, per_unit = [], {}
    try:
        # the mention tasks read captions, mentions and their .feats:
        # the train split keeps its boxes few and narrow (nothing here
        # trains on them); dev, which the image tasks and the joint
        # run score, has 20 boxes an image at 4096-d
        kw = dict(planted=True, emb_dim=MENTION_DIMS["emb_dim"],
                  vocab_size=MENTION_VOCAB, max_caption_len=32,
                  max_mentions_per_caption=3)
        t0 = time.perf_counter()
        n_train = generate_dataset(d, "train", SynthConfig(
            num_images=1100, seed=SEED, max_boxes_per_image=4,
            **kw))["mentions"]
        n_dev = generate_dataset(d, "dev", SynthConfig(
            num_images=275, seed=SEED + 1, max_boxes_per_image=20,
            **kw))["mentions"]
        _widen_boxes(f"{d}/dev.boxes.npz", AFF_DIMS["box_dim"], SEED)
        print(f"mention split: {n_train} train and {n_dev} dev mentions "
              f"written in {time.perf_counter() - t0:.1f} s")
        if n_train < 10000 or n_dev < n_train // 5:
            raise RuntimeError("the planted mention split is too small")

        def run(main_fn, argv):
            """One command line: wall clock; its log lines in said."""
            said.lines.clear()
            t0 = time.perf_counter()
            with _flags_kept():
                main_fn(argv)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        _reset(kernels)
        own = {}            # task -> the .scores its own CLI wrote
        printed = {}        # task -> the accuracy line --eval printed
        for task, (main_fn, _) in tasks.items():
            common = ["--data_dir", d, "--device", "cuda", "--batch_size",
                      str(MENTION_BATCH), "--seed", str(SEED)]
            train = ["--train", "--ckpt_every", "40", "--eval_every", "20",
                     *common]
            whole, cut = f"{d}/{task}.model", f"{d}/{task}.cut"
            # train: the model dir is the task's default, which the
            # server and the joint run read
            wall = run(main_fn, [*train, "--epochs", "10",
                                 "--metrics_file", f"{d}/{task}.jsonl"])
            loop = [re.search(r"training loop: (\d+) steps in (\S+) s "
                              r"\((\S+) steps/s\)", ln)
                    for ln in said.lines]
            n_steps, loop_s, steps_s = next(
                (int(m.group(1)), float(m.group(2)), float(m.group(3)))
                for m in loop if m)
            stalls = said.numbers(r"loop stalled (\d+) ms")
            rows = [json.loads(ln) for ln in open(f"{d}/{task}.jsonl")]
            evals = [r for r in rows if "eval_loss" in r]
            losses = [r["loss"] for r in rows if "loss" in r]
            if not (losses and evals and stalls
                    and all(np.isfinite(x) for x in losses)
                    and all(np.isfinite(r["eval_loss"]) for r in evals)):
                raise RuntimeError(f"icl-torch-{task} --train: bad "
                                   f"metrics {rows}")
            times.append(
                f"icl-torch-{task} --train [10 epochs of {n_train} "
                f"mentions, {MENTION_BATCH} a batch, hidden "
                f"{MENTION_DIMS['hidden']}, dropout {RATE}, eval every "
                f"20 and checkpoint every 40 steps]: {n_steps} steps at "
                f"{steps_s:.2f} steps/s, {10 * n_train / loop_s:.0f} "
                f"mentions/s in the loop, {np.mean(stalls):.1f} ms the "
                f"loop stalled per checkpoint save ({len(stalls)} "
                f"saves), loss {losses[0]:.4f} -> {losses[-1]:.4f}, dev "
                f"loss {evals[0]['eval_loss']:.4f} -> "
                f"{evals[-1]['eval_loss']:.4f}, dev accuracy "
                f"{evals[-1]['eval_acc']:.4f}; the command {wall:.2f} s")
            # a run stopped half way whose end marker is deleted
            run(main_fn, [*train, "--epochs", "5", "--model_file", cut])
            steps = sorted(int(n[5:-3]) for n in os.listdir(cut)
                           if n.startswith("step_"))
            os.unlink(f"{cut}/step_{steps[-1]}.pt")
            start = torch.load(f"{cut}/step_{steps[-2]}.pt",
                               weights_only=True)
            if steps[-2] % 40 or start["epoch"] >= 5 \
                    or not start["batch_in_epoch"]:
                raise RuntimeError(f"icl-torch-{task}: step {steps[-2]} "
                                   f"is no periodic mid-epoch checkpoint")
            run(main_fn, [*train, "--epochs", "10", "--resume", "auto",
                          "--model_file", cut])
            ends = [torch.load(f"{m}/step_{n_steps}.pt", weights_only=True)
                    for m in (whole, cut)]
            diff = _same_checkpoint(*ends)
            print(f"check icl-torch-{task} --resume auto from step "
                  f"{steps[-2]} (epoch {start['epoch']}, batch "
                  f"{start['batch_in_epoch']}) to step {ends[1]['step']}: "
                  f"weights and Adam state against the uninterrupted "
                  f"run's, bit for bit: "
                  f"{'ok' if not diff else 'FAIL ' + str(diff[:5])}")
            if diff:
                raise RuntimeError(f"icl-torch-{task}: the resumed run "
                                   f"differs in {diff[:5]}")

            # predict twice on the card, once on the CPU
            predict = ["--predict", "--eval", "--data_split", "dev",
                       *common]
            outs, tables = [], []
            for k in (1, 2):
                said.lines.clear()
                t0 = time.perf_counter()
                tables.append(_captured(main_fn, [
                    *predict, "--scores_file",
                    f"{d}/{task}.{k}.scores"]))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                rate = said.numbers(r"predict sweep: .*\((\d+) "
                                    r"mentions/s\)")
                times.append(
                    f"icl-torch-{task} --predict --eval [dev, {n_dev} "
                    f"mentions, run {k}]: {rate[0]:.0f} mentions/s in "
                    f"the sweep; the command {wall:.2f} s")
                outs.append(open(f"{d}/{task}.{k}.scores", "rb").read())
            own[task] = f"{d}/{task}.1.scores"
            printed[task] = _accuracy_line(tables[0])
            ids, probs = read_scores(own[task])
            gold_ids, gold = read_feats_labels(f"{d}/dev.{task}.feats")
            acc = float((probs.argmax(1) == gold.astype(int)).mean())
            argv = [a if a != "cuda" else "cpu" for a in predict]
            _captured(main_fn, [*argv, "--scores_file",
                                f"{d}/{task}.cpu.scores"])
            cpu_ids, cpu_probs = read_scores(f"{d}/{task}.cpu.scores")
            perr = float(np.abs(probs - cpu_probs).max())
            ok = (outs[0] == outs[1] and tables[0] == tables[1]
                  and ids == list(gold_ids) == cpu_ids
                  and len(ids) == n_dev and acc >= MENTION_GATE
                  and perr <= PROBS_GATE
                  and f"({int(round(acc * n_dev))}/{n_dev})"
                  in printed[task])
            print(f"check icl-torch-{task} --predict: two runs "
                  f"byte-identical, {len(ids)} ids in dataset order, dev "
                  f"accuracy {acc:.4f} (gate {MENTION_GATE}), --device "
                  f"cpu from the same checkpoint max|d| {perr:.3e} (gate "
                  f"{PROBS_GATE:.0e}): {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"icl-torch-{task} --predict failed")

            # export -> import into a fresh dir -> predict
            export_cli.main(["--model_file", whole, "--out",
                             f"{d}/{task}.export.npz"])
            import_cli.main(["--npz", f"{d}/{task}.export.npz",
                             "--model_file", f"{d}/{task}.imported"])
            _captured(main_fn, [
                *predict, "--model_file", f"{d}/{task}.imported",
                "--scores_file", f"{d}/{task}.imported.scores"])
            same = open(f"{d}/{task}.imported.scores", "rb").read() \
                == outs[0]
            print(f"check icl-torch-export -> icl-torch-import -> "
                  f"icl-torch-{task} --predict: .scores byte-identical "
                  f"to the trained model dir's: "
                  f"{'ok' if same else 'FAIL'}")
            if not same:
                raise RuntimeError(f"{task}: the imported model scores "
                                   f"differently")
        quiet = _count(kernels, "the mention command lines")
        if any(quiet.values()):
            raise RuntimeError(f"a mention run launched a kernel: "
                               f"{quiet}")

        # relation and affinity: an epoch on dev at full width into
        # their default model dirs, then their own predicts
        image = ["--data_dir", d, "--device", "cuda",
                 "--images_per_batch", "64", "--seed", str(SEED)]
        for task, main_fn in (("relation", relation_cli.main),
                              ("affinity", affinity_cli.main)):
            run(main_fn, ["--train", "--data_split", "dev", "--epochs",
                          "1", *image])
            own[task] = f"{d}/{task}.own.scores"
            argv = ["--predict", "--eval", "--data_split", "dev", *image,
                    "--scores_file", own[task]]
            if task == "affinity":
                own["rank"] = f"{d}/{task}.own.rank"
                argv += ["--rank_file", own["rank"]]
            printed[task] = _accuracy_line(_captured(main_fn, argv))
        for task in ("nonvisual", "cardinality", "relation", "affinity"):
            held = os.listdir(f"{d}/{task}.model")
            if any(n.endswith(".npz") for n in held) \
                    or os.path.exists(f"{d}/{task}.npz"):
                raise RuntimeError(f"{task}: an archive beside the "
                                   f"model dir")

        # the server over the four model dirs
        httpd = serve(d, port=0, warmup="basic")
        server = threading.Thread(target=httpd.serve_forever, daemon=True)
        server.start()
        try:
            lat = _drive_mentions(httpd, d, tasks)
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.join(timeout=10)
        for task, ms in lat.items():
            times.append(f"{task} request p50: client {ms['client_p50']:.2f}"
                         f" ms over {ms['n']} requests of 64 mentions, "
                         f"server predict p50 {ms['server_p50']} ms")

        # the joint run: every file against the task's own CLI's
        _reset(joint_kernels)
        t0 = time.perf_counter()
        tables = _captured(joint_cli.main, [
            "--predict", "--eval", "--data_split", "dev", *image,
            "--batch_size", str(MENTION_BATCH), "--with_cardinality",
            "--with_rank"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read(joint_kernels, "icl-torch-joint")
        per_unit["icl-torch-joint --with_cardinality --with_rank"] = \
            launches
        wrote = {t: f"{d}/dev.{t}.scores" for t in tasks}
        wrote.update(relation=f"{d}/dev.relation.scores",
                     affinity=f"{d}/dev.affinity.scores",
                     rank=f"{d}/dev.affinity.rank")
        differ = [t for t, path in wrote.items()
                  if open(path, "rb").read() != open(own[t], "rb").read()]
        lines = [ln for ln in tables.splitlines()
                 if ln.startswith("Accuracy:")]
        want = [printed[t] for t in ("nonvisual", "relation", "affinity",
                                     "cardinality")]
        print(f"check icl-torch-joint --with_cardinality --with_rank: "
              f"{len(wrote)} files byte-equal to the tasks' own CLIs', "
              f"the four tables' accuracies theirs: "
              f"{'ok' if not differ and lines == want else 'FAIL'} "
              f"{differ}")
        if differ or lines != want:
            raise RuntimeError(f"icl-torch-joint: {differ}, {lines} "
                               f"against {want}")
        sizes = {t: len(read_scores(p)[0]) for t, p in wrote.items()}
        times.append(f"icl-torch-joint --with_cardinality --with_rank "
                     f"--eval [dev, 275 images: {sizes}]: the command "
                     f"{wall:.2f} s")

        # icl-torch-eval and icl-torch-check over what was written
        for task in ("nonvisual", "cardinality", "relation", "affinity"):
            table = _captured(evaluate_cli.main, [
                "--task", task, "--scores", wrote[task], "--feats",
                f"{d}/dev.{task}.feats", "--strict"])
            if _accuracy_line(table) != printed[task]:
                raise RuntimeError(f"icl-torch-eval {task}: "
                                   f"{_accuracy_line(table)} against "
                                   f"{printed[task]}")
            found = _captured(check_cli.main, [
                "--scores", wrote[task], "--task", task, "--strict"])
            if "0 error(s), 0 warning(s)" not in found:
                raise RuntimeError(f"icl-torch-check {task}: {found}")
        ground = _captured(evaluate_cli.main, [
            "--task", "grounding", "--scores", wrote["rank"], "--feats",
            f"{d}/dev.affinity.feats", "--strict"])
        found = _captured(check_cli.main, ["--data_dir", d,
                                           "--data_split", "dev"])
        if "0 error(s)" not in found:
            raise RuntimeError(f"icl-torch-check: {found}")
        print(f"check icl-torch-eval: the four accuracies --eval "
              f"printed ({'; '.join(printed[t] for t in printed)}); "
              f"{ground.strip()}; icl-torch-check of dev and the four "
              f".scores: {found.strip().splitlines()[-1]}")

        profiles = _mention_profiles(d)
    finally:
        logger.removeHandler(said)
    return {"launches": launches, "per_unit": per_unit, "times": times,
            "profiles": profiles}


def _mention_profiles(d: str) -> list:
    """Where the time of one mention train step and of one predict call
    goes, in process at full width on the split's first 512 mentions."""
    dev = torch.device("cuda")
    emb = EmbeddingStore.load(f"{d}/embeddings.txt")
    ds = load_mention_dataset(d, "train", "nonvisual", emb)
    table = torch.from_numpy(emb.table).to(dev)
    rows = slice(0, MENTION_BATCH)
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in (ds.token_ids[rows], ds.lengths[rows],
                            ds.labels[rows], np.ones(MENTION_BATCH, bool)))
    model = NonvisualModel(**MENTION_DIMS, dropout=RATE, device=dev)
    state = create_train_state(model, seed=SEED)
    step = make_mention_train_step()
    shape = f"[{MENTION_BATCH} mentions x {ds.max_len} tokens, hidden " \
            f"{MENTION_DIMS['hidden']}]"
    return [_profile(f"mention train step, dropout {RATE} {shape}",
                     lambda: step(state, table, *batch)),
            _profile(f"mention predict call {shape}",
                     lambda: mention_predict(model, table, *batch[:2]))]


def _drive_mentions(httpd, d: str, tasks: dict) -> dict:
    """The mention endpoints (8 requests of 64 mentions, 4 concurrent, a
    repeat) against the trained model on the CPU; the image endpoints of
    the same server; /healthz."""
    url = f"http://127.0.0.1:{httpd.server_port}"
    scorer = httpd.RequestHandlerClass.scorer
    if sorted(scorer.tasks) != ["affinity", "cardinality", "nonvisual",
                                "relation"]:
        raise RuntimeError(f"the server loaded {sorted(scorer.tasks)}")
    rng = np.random.default_rng(SEED + 2)
    requests = [_mention_request(rng, k) for k in range(8)]
    cpu_table = scorer.table.cpu()
    lat = {}
    for task, (_, model_cls) in tasks.items():
        path = f"/score/{task}"
        plain = model_cls(**MENTION_DIMS)
        plain.load_flat(Checkpointer(f"{d}/{task}.model").load_weights()[0])
        ms, first, worst = [], None, 0.0
        for req in requests:
            status, raw, t = _post(url, req, path)
            if status != 200:
                raise RuntimeError(f"{task} request: HTTP {status}")
            ms.append(t)
            first = first or raw
            body = json.loads(raw)
            tok = np.zeros((64, 8), np.int32)
            ln = np.zeros(64, np.int32)
            for r, m in enumerate(req["mentions"]):
                tok[r], ln[r] = scorer.emb.encode_tokens(m["tokens"], 8)
            want = mention_predict(plain, cpu_table, torch.from_numpy(tok),
                                   torch.from_numpy(ln)).numpy()
            got = np.array([s["probs"] for s in body["scores"]])
            if [s["id"] for s in body["scores"]] != [
                    m["id"] for m in req["mentions"]] \
                    or got.shape != want.shape:
                raise RuntimeError(f"{task} request: bad response")
            worst = max(worst, float(np.abs(got - want).max()))
        with ThreadPoolExecutor(4) as pool:
            again = list(pool.map(lambda q: _post(url, q, path),
                                  requests[:4]))
        status, repeat, _ = _post(url, requests[0], path)
        ok = (worst <= PROBS_GATE and repeat == first
              and all(r[0] == 200 for r in again)
              and again[0][1] == first)
        print(f"check /score/{task}: 8 requests of 64 mentions, 4 "
              f"concurrent, a repeat byte-identical; probs against the "
              f"trained model on the CPU max|d| {worst:.3e} (gate "
              f"{PROBS_GATE:.0e}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"/score/{task} failed")
        ms.sort()
        lat[task] = {"client_p50": ms[len(ms) // 2], "n": len(ms)}
    rng = np.random.default_rng(SEED + 3)
    status, raw, _ = _post(url, {"images": [_image(rng, 0)]})
    if status != 200:
        raise RuntimeError(f"relation request: HTTP {status}")
    _check_body(json.loads(raw), 1)
    status, raw, _ = _post(url, {"images": [_affinity_image(rng, 0)]},
                           "/score/affinity")
    if status != 200:
        raise RuntimeError(f"affinity request: HTTP {status}")
    _check_affinity_body(json.loads(raw), 1)
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        health = json.loads(r.read())
    co = health["coalescer"]
    if co["mention_calls"] != 26 or co["mention_items"] != 26 * 64 \
            or co["items"] < 2:
        raise RuntimeError(f"bad /healthz: {health}")
    print(f"check the four endpoints from one server over the model dirs; "
          f"/healthz: {json.dumps(health)}")
    for task in lat:
        lat[task]["server_p50"] = health["latency_ms"][task]["p50_ms"]
    return lat


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class _Ranks:
    """``world`` processes of one ``python -m`` command line, each with its
    output in a file and its launch counts in a stats file
    (``ICL_TORCH_RUN_STATS``).  ``command(k, port)``: rank k's module and
    arguments."""

    live: list = []       # every process started and not yet reaped

    def __init__(self, what: str, command, world: int, scratch: str):
        self.what, self.world = what, world
        tag = re.sub(r"\W+", "_", what)
        self.stats = f"{scratch}/{tag}.stats"
        self.logs = [f"{scratch}/{tag}.rank{k}.log" for k in range(world)]
        env = dict(os.environ, ICL_TORCH_RUN_STATS=self.stats,
                   ICL_TORCH_DIST_TIMEOUT="300",
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        port = _free_port()
        self.procs = []
        for k in range(world):
            with open(self.logs[k], "w") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", *command(k, port)], env=env,
                    stdout=out, stderr=subprocess.STDOUT,
                    cwd=env["PYTHONPATH"]))
        _Ranks.live += self.procs

    @classmethod
    def cli(cls, what: str, task: str, argv: list, world: int, scratch: str,
            per_rank=None) -> "_Ranks":
        """``icl_torch.cli.<task>``; the bootstrap flags when world > 1."""
        def command(k, port):
            boot = [] if world == 1 else [
                "--coordinator", f"localhost:{port}", "--num_processes",
                str(world), "--process_id", str(k)]
            return [f"icl_torch.cli.{task}", *argv, *boot,
                    *(per_rank(k) if per_rank else [])]
        return cls(what, command, world, scratch)

    def wait(self, timeout: float = 300.0) -> "_Ranks":
        """Every rank's exit; raises with the log's end if one failed."""
        deadline = time.monotonic() + timeout
        for k, p in enumerate(self.procs):
            try:
                p.wait(max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                _Ranks.stop()
                raise RuntimeError(f"{self.what}: rank {k} did not end in "
                                   f"{timeout:.0f} s:\n{self.said(k)[-3000:]}")
        for k, p in enumerate(self.procs):
            if p.returncode != 0:
                raise RuntimeError(f"{self.what}: rank {k} exited with "
                                   f"{p.returncode}:\n{self.said(k)[-3000:]}")
        self.counts = []
        for k in range(self.world):
            with open(f"{self.stats}.rank{k}.json") as f:
                self.counts.append(json.load(f))
            for line in self.said(k).splitlines():
                if "[WARNING] replicate" in line:     # ranks held to rank 0
                    print(f"{self.what}, rank {k}: {line}")
        return self

    def said(self, k: int) -> str:
        with open(self.logs[k]) as f:
            return f.read()

    def number(self, pattern: str, k: int = 0) -> float:
        m = re.search(pattern, self.said(k))
        if not m:
            raise RuntimeError(f"{self.what}: rank {k} logged nothing like "
                               f"{pattern!r}:\n{self.said(k)[-3000:]}")
        return float(m.group(1))

    def need(self, names, per_unit: dict) -> None:
        """Every rank launched each of ``names``; books the counts."""
        for k, c in enumerate(self.counts):
            per_unit[f"{self.what}, rank {k} of {self.world}"] = c["launches"]
            missing = [n for n in names if c["launches"][n] < 1]
            if missing:
                raise RuntimeError(f"{self.what}: rank {k} did not launch "
                                   f"{missing}: {c['launches']}")

    @staticmethod
    def stop() -> None:
        for p in _Ranks.live:
            if p.poll() is None:
                p.kill()
        for p in _Ranks.live:
            p.wait()
        _Ranks.live = []


def _weights_gap(a: str, b: str) -> tuple:
    """(max |a - b|, the share of weights with |a - b| > 1e-5) over the
    weights of two checkpoint files."""
    wa = torch.load(a, weights_only=True)["model"]
    wb = torch.load(b, weights_only=True)["model"]
    if sorted(wa) != sorted(wb):
        raise RuntimeError(f"{a} and {b} hold other weights")
    gaps = torch.cat([(wa[k] - wb[k]).abs().flatten() for k in wa])
    return float(gaps.max()), float((gaps > 1e-5).float().mean())


def _rank_steps(cli_dir: str, scratch: str, emb, trained, per_unit) -> None:
    """One grid-loss train step of each image task at full width as two
    ranks on the card (``icl_torch.testing.dist_worker``: real ranks, gloo),
    held to one process that runs the ranks' two half batches one after the
    other (:func:`icl_torch.testing.dist_worker.split_step`): gradients and
    loss within the kernel gate, the weights through Adam.  One process
    over the whole batch in ONE call is printed beside it and held to
    nothing: cuBLAS picks its kernel by the row count, so 64 rows round the
    head's projections otherwise than 32 (by under 1e-6), and a ReLU unit
    that close to zero then switches, which moves a few gradient rows by a
    hundredth."""
    dev = "cuda"
    rel = [b.arrays for b in RelationBatcher(
        images_per_batch=64, build_grid=True).batches(
            load_relation_dataset(cli_dir, "train", emb))]
    aff = [b.arrays for b in AffinityBatcher(
        images_per_batch=64, with_ids=False).batches(
            load_affinity_dataset(cli_dir, "train", emb))]
    ragged = [a for a in rel if 32 < int(a["img_valid"].sum()) < 64]
    picked = {
        "relation": max(rel, key=lambda a: int(a["pair_valid"].sum())),
        # rank 1 feeds real images and padding
        "relation_ragged": (ragged or rel)[-1],
        "affinity": max(aff, key=lambda a: int(a["grid_valid"].sum()))}
    cases = []
    for name, arrays in picked.items():
        task = name.split("_")[0]
        dims = DIMS if task == "relation" else AFF_DIMS
        params = {k: v.numpy() for k, v in init_params(task, SEED,
                                                       dims).items()}
        np.savez(f"{scratch}/{name}.npz", table=emb.table,
                 **{f"batch/{k}": v for k, v in arrays.items()},
                 **{f"param/{k}": v for k, v in params.items()})
        cases.append({"name": name, "task": task, "steps": 1, "seed": SEED,
                      "model": {**dims, "fused": True, "dropout": RATE},
                      "grid_loss": True, "class_weights":
                          [0.3, 1.0, 1.0, 1.0] if task == "relation"
                          else None})
    with open(f"{scratch}/cases.json", "w") as f:
        json.dump(cases, f)
    ranks = _Ranks("two ranks: one train step a case",
                   lambda k, port: ["icl_torch.testing.dist_worker", "steps",
                                    str(k), "2", str(port), scratch, "2",
                                    dev], 2, scratch)
    own = {c["name"]: {n: dist_worker.run_case(scratch, c, None, dev, split=n)
                       for n in (2, 1)} for c in cases}
    ranks.wait().need(trained, per_unit)
    for c in cases:
        name, images = c["name"], int(picked[c["name"]]["img_valid"].sum())
        r0, r1 = (dict(np.load(f"{scratch}/{name}.rank{k}.npz"))
                  for k in range(2))
        equal = all(np.array_equal(r0[k], r1[k]) for k in r0)
        gaps = {}
        for n, one in own[name].items():
            for kind in ("grad", "param"):
                keys = [k for k in one if k.startswith(kind + "/")]
                gaps[n, kind] = max(
                    float(np.abs(r0[k] - one[k]).max())
                    / max(1.0, float(np.abs(one[k]).max())) for k in keys)
            apart = np.concatenate([np.abs(r0[k] - one[k]).ravel()
                                    for k in one if k.startswith("param/")])
            gaps[n, "share"] = float((apart > 1e-5).mean())
            gaps[n, "loss"] = abs(float(r0["loss"][0] - one["loss"][0]))
        # the weights are held through Adam, whose first step moves a
        # weight by (learning rate) x g / (|g| + 1e-8): where |g| is of the
        # size of 1e-8 the last bit of a sum shows as 1e-5 in the weight
        ok = (equal and gaps[2, "grad"] <= KERNEL_GATE
              and gaps[2, "loss"] <= KERNEL_GATE and gaps[2, "share"] <= 1e-4)
        print(f"check two ranks, one {c['task']} train step on the card "
              f"[{name}: {images} images of 64, 32 rows a rank]: the ranks' "
              f"weights and gradients equal bit for bit: {equal}; against "
              f"one process over the same two half batches max|d| "
              f"gradients {gaps[2, 'grad']:.3e}, loss {gaps[2, 'loss']:.3e} "
              f"(gate {KERNEL_GATE:.0e} x max(1, max|that|)), weights "
              f"{gaps[2, 'param']:.3e} with {gaps[2, 'share']:.2e} of them "
              f"beyond 1e-5 (gate 1e-4 of them): {'ok' if ok else 'FAIL'}; "
              f"against one process over the whole batch in one call (other "
              f"row counts, other roundings; held to nothing): gradients "
              f"{gaps[1, 'grad']:.3e}, loss {gaps[1, 'loss']:.3e}, weights "
              f"{gaps[1, 'param']:.3e} with {gaps[1, 'share']:.2e} beyond "
              f"1e-5")
        if not ok:
            raise RuntimeError(f"two ranks: the {name} step disagrees with "
                               f"one process over the same half batches")


def _replicated(r) -> str | None:
    """None if both ranks of a run logged their fresh train state equal on
    all ranks, else what replicate said (the tensors apart, by name)."""
    lines = [ln for k in range(2) for ln in r.said(k).splitlines()
             if "replicate: the train state" in ln]
    if all("replicate: the train state equal on all 2 ranks" in r.said(k)
           for k in range(2)):
        return None
    return " | ".join(lines) or "no replicate line"


def _dist(cli_dir: str, men_dir: str, card: str) -> dict:
    """Data parallelism on the one card: a world of one over NCCL in this
    process, then the command lines as two ranks that share the card (gloo
    through the host), against the same command lines as one process."""
    dev = torch.device("cuda")
    kernels = {**PREDICT_KERNELS, **TRAIN_KERNELS,
               "affinity_rank": affinity_rank}
    _reset(kernels)
    per_unit, times = {}, []
    emb = EmbeddingStore.load(f"{cli_dir}/embeddings.txt")
    table = torch.from_numpy(emb.table).to(dev)

    # a world of one, NCCL: the data-parallel step is the plain step
    rt = runtime.init(None, seed=SEED, coordinator=f"localhost:{_free_port()}",
                      num_processes=1, process_id=0, device="cuda")
    if rt.backend != "nccl":
        raise RuntimeError(f"a world of one on the card chose {rt.backend}")
    ds = load_relation_dataset(cli_dir, "train", emb)
    batch = max((b.arrays for b in RelationBatcher(
        images_per_batch=64, build_grid=True).batches(ds)),
        key=lambda a: int(a["pair_valid"].sum()))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    ends = []
    for mesh in (rt.mesh, None):
        model = RelationModel(**DIMS, fused=True, dropout=RATE, device=dev)
        state = create_train_state(model, seed=SEED)
        step = make_relation_train_step(class_weights=[0.3, 1.0, 1.0, 1.0],
                                        grid_loss=True, mesh=mesh)
        metrics = step(state, table, batch)
        ends.append((model.flat_params(), float(metrics["loss"])))
    floats = {"relation": sum(p.numel() for p in model.parameters())}
    grads = [p.grad for p in model.parameters()]
    calls = dist_mesh.REDUCE_STATS["calls"]
    nccl_ms = _time_ms(lambda: dist_mesh.all_reduce_sum(grads, rt.mesh))
    same = (ends[0][1] == ends[1][1] and all(
        torch.equal(v, ends[1][0][k]) for k, v in ends[0][0].items()))
    print(f"check a world of one over NCCL (runtime.init chose "
          f"{rt.backend}; the only NCCL evidence one card can give): one "
          f"relation train step at full width [I=64, "
          f"{int(batch['pair_valid'].sum())} pairs] through the "
          f"data-parallel step against the plain step, "
          f"{len(ends[0][0])} tensors and the loss bit for bit: "
          f"{'ok' if same and calls == 2 else 'FAIL'}; the flat gradient "
          f"all-reduce of {floats['relation']} floats "
          f"({4 * floats['relation']} bytes) over one rank: "
          f"{nccl_ms:.4f} ms a call by CUDA events ({card})")
    if not same or calls != 2:
        raise RuntimeError("the data-parallel step over one rank differs "
                           "from the plain step")
    runtime.shutdown()
    del batch, ends, grads, model, state
    floats["affinity"] = sum(p.numel() for p in AffinityModel(
        **AFF_DIMS, device=dev).parameters())
    scratch = f"{cli_dir}/ranks"
    os.makedirs(scratch)
    trained = ("lstm_recurrence", "grid_head_train_loss_fwd",
               "grid_head_train_loss_bwd")
    try:
        _rank_steps(cli_dir, scratch, emb, trained, per_unit)
    finally:
        _Ranks.stop()

    image = ["--device", "cuda", "--images_per_batch", "64", "--seed",
             str(SEED), *HIGHEST]
    men = ["--data_dir", men_dir, "--device", "cuda", "--batch_size",
           str(MENTION_BATCH), "--seed", str(SEED), *HIGHEST]
    try:
        # round 1: a first epoch with a checkpoint a step, two ranks and
        # (here, meanwhile) one process; nonvisual a whole epoch
        def first(task, d, extra):
            return ["--train", "--data_dir", d, *extra, "--epochs", "1",
                    "--ckpt_every", "1"]
        runs = {
            "relation": _Ranks.cli(
                "two ranks: icl-torch-relation --train", "relation",
                [*first("relation", cli_dir, image), "--model_file",
                 f"{scratch}/relation.mp"], 2, scratch,
                lambda k: ["--metrics_file", f"{scratch}/relation.{k}.jsonl",
                           "--eval_every", "1"]),
            "affinity": _Ranks.cli(
                "two ranks: icl-torch-affinity --train", "affinity",
                [*first("affinity", cli_dir, image), "--model_file",
                 f"{scratch}/affinity.mp"], 2, scratch),
            "nonvisual": _Ranks.cli(
                "two ranks: icl-torch-nonvisual --train", "nonvisual",
                ["--train", *men, "--epochs", "1", "--model_file",
                 f"{scratch}/nonvisual.mp"], 2, scratch)}
        with _flags_kept():
            relation_cli.main([*first("relation", cli_dir, image),
                               "--model_file", f"{scratch}/relation.one",
                               "--eval_every", "1"])
            affinity_cli.main([*first("affinity", cli_dir, image),
                               "--model_file", f"{scratch}/affinity.one"])
            nonvisual_cli.main(["--train", *men, "--epochs", "1",
                                "--model_file", f"{scratch}/nonvisual.one"])
        fresh = {}   # two-rank runs from a fresh state -> what replicate said
        for task, r in runs.items():
            r.wait()
            for k in range(2):
                if "sums over gloo" not in r.said(k):
                    raise RuntimeError(f"{r.what}: rank {k} did not log "
                                       f"gloo:\n{r.said(k)[-2000:]}")
            if task != "nonvisual":
                r.need(trained, per_unit)
            fresh[r.what] = _replicated(r)
        # the earliest step both runs still hold (a model dir keeps its
        # three newest checkpoints: step 1 where the epoch has three steps)
        early = {}
        for task in ("relation", "affinity"):
            n = min(int(f[5:-3]) for f in os.listdir(f"{scratch}/{task}.mp")
                    if f.startswith("step_"))
            early[task] = (n, _weights_gap(f"{scratch}/{task}.mp/step_{n}.pt",
                                           f"{scratch}/{task}.one/step_{n}.pt"))
        # round 2: the relation run resumed to 5 epochs, two ranks and one
        # process; meanwhile the three sharded predicts
        more = ["--train", "--data_dir", cli_dir, *image, "--epochs", "5",
                "--resume", "auto"]
        resumed = _Ranks.cli("two ranks: icl-torch-relation --train "
                             "--resume auto", "relation",
                         [*more, "--model_file", f"{scratch}/relation.mp"],
                         2, scratch)
        predicts = {}
        for task, d, model_dir, extra in (
                ("relation", cli_dir, f"{cli_dir}/relation.whole", image),
                ("affinity", cli_dir, f"{cli_dir}/affinity.whole", image),
                ("nonvisual", men_dir, f"{men_dir}/nonvisual.model",
                 men[2:])):
            argv = ["--predict", "--eval", "--data_split", "dev",
                    "--data_dir", d, *extra, "--model_file", model_dir,
                    "--scores_file", f"{scratch}/{task}.mp.scores"]
            if task == "affinity":
                argv += ["--rank_file", f"{scratch}/{task}.mp.rank"]
            predicts[task] = (_Ranks.cli(
                f"two ranks: icl-torch-{task} --predict --eval", task, argv,
                2, scratch), argv)
        with _flags_kept():
            relation_cli.main([*more, "--model_file",
                               f"{scratch}/relation.one"])
        resumed.wait().need(trained, per_unit)

        # the weights against the one-process command line's.  That run
        # feeds 64 rows a call where a rank feeds 32, so the two round
        # otherwise (see _rank_steps), and Adam, whose first steps move
        # every weight by the learning rate whatever its gradient's size,
        # carries a switched unit into many weights.  Held to: early on,
        # all but a ten-thousandth of the weights within 1e-5; at the end,
        # no weight farther than a quarter of learning rate x steps (two
        # runs that stepped apart every time would be 8 times that), and
        # every rank's log saying the ranks ended with one state.
        for task, ends in (("relation", [runs["relation"], resumed]),
                           ("affinity", [runs["affinity"]]),
                           ("nonvisual", [runs["nonvisual"]])):
            mp, one = f"{scratch}/{task}.mp", f"{scratch}/{task}.one"
            steps = [sorted(int(n[5:-3]) for n in os.listdir(m)
                            if n.startswith("step_")) for m in (mp, one)]
            last = steps[0][-1]
            far, share = _weights_gap(f"{mp}/step_{last}.pt",
                                      f"{one}/step_{last}.pt")
            said = (f"after step {last} max|d| {far:.3e} (gate "
                    f"{0.25e-3 * last:.2e}), {share:.2e} of them beyond 1e-5")
            ok = far <= 0.25e-3 * last
            if task in early:
                n, (far1, share1) = early[task]
                said = (f"after step {n} {share1:.2e} of the weights beyond "
                        f"1e-5 (gate 1e-4; max|d| {far1:.3e}), " + said)
                ok = ok and share1 <= 1e-4
            one_state = all(
                "replicate: the trained state equal on all 2 ranks"
                in r.said(k) for r in ends for k in range(2))
            listing = sorted(os.listdir(mp))
            alone = (all(n.startswith("step_") or n in (
                "model_config.json", "train_config.json") for n in listing)
                and os.path.exists(f"{scratch}/relation.0.jsonl")
                and not os.path.exists(f"{scratch}/relation.1.jsonl"))
            with open(f"{mp}/train_config.json") as f:
                cfg = json.load(f)
            ok = (ok and alone and one_state and steps[0] == steps[1]
                  and last >= 3 and cfg["_num_devices"] == 2
                  and cfg["_reduce_backend"] == "gloo")
            print(f"check two ranks: icl-torch-{task} --train against one "
                  f"process from one seed: {said}; the ranks ended with one "
                  f"state, bit for bit: {one_state}; the model dir holds "
                  f"rank 0's files alone {listing} (rank 1 left no metrics "
                  f"file of its own); train_config.json: "
                  f"{cfg['_num_devices']} devices, "
                  f"{cfg['_reduce_backend']}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"two ranks: icl-torch-{task} --train "
                                   f"failed its check")
        # what the two trained relation models say of dev
        probs = []
        for tag in ("mp", "one"):
            _captured(relation_cli.main, [
                "--predict", "--data_dir", cli_dir, "--data_split", "dev",
                *image, "--model_file", f"{scratch}/relation.{tag}",
                "--scores_file", f"{scratch}/trained.{tag}.scores"])
            probs.append(read_scores(f"{scratch}/trained.{tag}.scores")[1])
        apart = float(np.abs(probs[0] - probs[1]).max())
        print(f"check two ranks: dev probabilities of the relation model "
              f"two ranks trained against the one a single process trained "
              f"({len(probs[0])} pairs): max|d| {apart:.3e} (gate 5e-3): "
              f"{'ok' if apart <= 5e-3 else 'FAIL'}")
        if apart > 5e-3:
            raise RuntimeError("the two-rank model scores dev otherwise")

        # the sharded predicts against the one-process files and tables
        for task, (r, argv) in predicts.items():
            r.wait()
            names = ["lstm_recurrence", "grid_head"] + (
                ["affinity_rank"] if task == "affinity" else [])
            r.need(names if task != "nonvisual" else [], per_unit)
            mains = {"relation": relation_cli.main,
                     "affinity": affinity_cli.main,
                     "nonvisual": nonvisual_cli.main}
            one = [a.replace(".mp.", ".one.") for a in argv]
            table_one = _captured(mains[task], one)
            tables = [r.said(k) for k in range(2) if "Accuracy:" in r.said(k)]
            files = [f"{scratch}/{task}.mp.scores"] + (
                [f"{scratch}/{task}.mp.rank"] if task == "affinity" else [])
            worst, same_ids = 0.0, True
            for path in files:
                ids, probs = read_scores(path)
                ids1, probs1 = read_scores(path.replace(".mp.", ".one."))
                same_ids = same_ids and ids == ids1 and len(ids) > 1000
                worst = max(worst, float(np.abs(probs - probs1).max()))
            first_file = (f"{cli_dir}/{task}.1.scores" if task != "nonvisual"
                          else f"{men_dir}/{task}.1.scores")
            with open(first_file, "rb") as f, open(files[0].replace(
                    ".mp.", ".one."), "rb") as g:
                as_before = f.read() == g.read()
            left = [n for n in os.listdir(scratch) if "part-" in n]
            ok = (same_ids and worst <= 1.0000001e-6 and as_before
                  and len(tables) == 1 and not left
                  and _accuracy_line(table_one) in tables[0]
                  and table_one.strip() in tables[0])
            print(f"check two ranks: icl-torch-{task} --predict --eval"
                  f"{' --rank_file' if task == 'affinity' else ''} on dev: "
                  f"{len(ids)} ids in the one-process file's order (that "
                  f"file byte-equal to the earlier phase's), probabilities "
                  f"max|d| {worst:.1e} (gate: one unit of the sixth "
                  f"decimal), the table printed once and equal "
                  f"({_accuracy_line(table_one)}), no part file left: "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"two ranks: icl-torch-{task} --predict "
                                   f"failed its check")

        # round 3: the loop's speed, 20 epochs with no eval and no periodic
        # save: two ranks, then one process started the same way
        timing = ["--train", "--data_dir", cli_dir, *image, "--epochs", "20",
                  "--ckpt_every", "0"]
        speed = {}
        for world in (2, 1):
            r = _Ranks.cli(f"{world} rank(s): icl-torch-relation --train, "
                           f"20 epochs", "relation",
                       [*timing, "--model_file", f"{scratch}/speed.{world}"],
                       world, scratch).wait()
            speed[world] = r.number(r"training loop: .*\((\S+) steps/s\)")
            n_steps = int(r.number(r"training loop: (\d+) steps"))
            if world == 2:
                r.need(trained, per_unit)
                fresh[r.what] = _replicated(r)
                reduce_ms = [r.number(r"all-reduce \(gloo\): \d+ calls, "
                                      r"(\S+) ms", k) for k in range(2)]
                reduce_bytes = r.number(r"all-reduce \(gloo\): .* ms and "
                                        r"(\d+) bytes a step")
        # the fresh train states of every two-rank run, bit for bit: each
        # rank draws them from the seed (icl_torch/params.py), and
        # replicate holds them to rank 0's (REPLICA_NOISE is for rounding
        # of a restore, not of a fresh draw)
        equal = all(said is None for said in fresh.values())
        print(f"check two ranks: fresh train states bit-equal on both ranks "
              f"in {len(fresh)} runs (worst gap 0): "
              + ("ok" if equal else f"FAIL {fresh}"))
        if not equal:
            raise RuntimeError(f"two ranks: fresh train states apart {fresh}")
        times.append(
            f"two ranks on one card, icl-torch-relation --train [{n_steps} "
            f"steps of 64 images, 32 a rank, no eval, no periodic save]: "
            f"{speed[2]:.2f} steps/s in the loop, one process started the "
            f"same way {speed[1]:.2f} steps/s; the all-reduces (four loss "
            f"sums, then the gradients) {reduce_ms[0]:.3f} / "
            f"{reduce_ms[1]:.3f} ms a step on ranks 0 / 1 and "
            f"{reduce_bytes:.0f} bytes a step, backend gloo through a "
            f"pinned host buffer (both ranks on cuda:0, so NCCL is not "
            f"chosen); trained floats: relation {floats['relation']} "
            f"({4 * floats['relation']} bytes of gradients a step), "
            f"affinity {floats['affinity']} ({4 * floats['affinity']} "
            f"bytes)")
    finally:
        _Ranks.stop()
    launches = _count(kernels, "this process over the two-rank phase")
    for counts in per_unit.values():
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    print(f"check launches over the two-rank phase, both ranks of every "
          f"run and this process: {launches}")
    return {"launches": launches, "per_unit": per_unit, "times": times}


if __name__ == "__main__":
    sys.exit(main())
