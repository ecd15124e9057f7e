"""Generic training loop: stepping, logging, checkpointing, profiling
(counterpart of ``icl/train/loop.py``).

The loop is task-agnostic: the CLI hands it a ``step_fn(state, *args) ->
metrics`` that updates the state in place (``icl_torch.train.steps``) and a
``make_batches(epoch_rng, skip=0)`` factory yielding per-step argument
tuples whose tensors already lie on the device.

* ``profile_dir`` wraps the loop in a ``torch.profiler`` trace, and the
  port's own spans and counters with it (:func:`profile_trace`); step wall
  clock and examples/sec are logged every ``log_every`` steps;
* a checkpoint every ``ckpt_every`` steps and at the end;
  ``resume='auto'`` restores the latest before training;
* a JSONL metrics stream, one object per logged step.

The host never waits for the device inside the loop: PyTorch queues the
step's kernels and returns, the step counter is mirrored on the host, and
the device is only read at log, eval and checkpoint points.

Under a process group (``LoopConfig.mesh``) every rank runs this loop in
lockstep over its own rows of the same schedule.  The metrics file is
written by the main process alone (checkpoint saves gate themselves in
:class:`~icl_torch.train.checkpoint.Checkpointer`); the eval sums are
all-reduced inside the hook, so every rank reads the same dev loss, takes
the same early-stop decision at the same step and restores the same best
state; ``--resume auto`` restores the step rank 0 names, and the ranks'
states are held to rank 0's at the start and again at the end
(:func:`icl_torch.dist.mesh.replicate`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from icl_torch.dist import mesh as dist_mesh
from icl_torch.dist.mesh import Mesh, is_main_process, replicate
from icl_torch.train.checkpoint import (Checkpointer, load_into, snapshot,
                                        to_host)
from icl_torch.train.state import TrainState
from icl_torch.util import trace
from icl_torch.util.log import LOG


@dataclasses.dataclass
class LoopConfig:
    epochs: int = 10
    ckpt_dir: str | None = None
    ckpt_every: int = 200
    log_every: int = 20
    profile_dir: str | None = None
    resume: str = "none"          # "none" | "auto"
    metrics_path: str | None = None
    seed: int = 0
    eval_every: int = 0           # steps between dev evals (0: off)
    early_stop: int = 0           # stop after N consecutive evals without
                                  # eval-loss improvement (0: off; needs
                                  # eval_every)
    mesh: Mesh | None = None      # the process mesh (None: one process)


def prefetch(iterator, depth: int = 2):
    """Run the batch generator in a BACKGROUND THREAD with a bounded queue.

    Host-side batch assembly (numpy padding and id bookkeeping) takes
    milliseconds a batch, so a same-thread generator leaves the loop
    host-bound.  The worker thread overlaps assembly with the device's
    work, and the host-to-device copies inside the generator start
    ``depth`` batches ahead of the consuming step.  Order-preserving;
    generator exceptions re-raise at the consumer.  An abandoned consumer
    (step_fn raised, generator closed early) sets a stop event that the
    worker observes at its next queue interaction, so neither the thread
    nor its device-ready batches outlive the epoch that needed them.

    Spans (:mod:`icl_torch.util.trace`): ``prefetch.wait``, the consumer's
    wait for the next item; ``prefetch.produce``, the worker's
    ``next(iterator)``, with the spans and counters made inside it.  The
    worker cannot see whether a profile runs, so each item carries what
    was made for it, and the consumer records that when it takes the item.
    """
    import queue as _queue
    import threading

    q: _queue.Queue = _queue.Queue(maxsize=max(depth, 1))
    _end = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    def _worker():
        it = iter(iterator)
        try:
            while True:
                try:
                    got = trace.hold("prefetch.produce", it.__next__)
                except StopIteration:
                    break
                if not _put(got):
                    return
            _put(_end)
        except BaseException as e:   # noqa: BLE001 — re-raised below
            _put(e)

    threading.Thread(target=_worker, daemon=True,
                     name="icl-batch-prefetch").start()
    try:
        while True:
            with trace.span("prefetch.wait"):
                got = q.get()
            if got is _end:
                return
            if isinstance(got, BaseException):
                raise got
            item, held = got
            trace.take(held)
            yield item
    finally:
        stop.set()


def profile_trace(profile_dir: str | None):
    """A ``torch.profiler`` context that, when it closes, writes into
    ``profile_dir`` a Chrome trace (CPU, and CUDA where there is a card),
    ``trace_<pid>.json``, and the port's spans and counters kept while it
    ran, ``spans_<pid>.jsonl`` (:func:`icl_torch.util.trace.write_jsonl`;
    the prefetch worker's spans are only there), then empties that log; a
    null context without a directory."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)

    def write(prof):
        prof.export_chrome_trace(os.path.join(
            profile_dir, f"trace_{os.getpid()}.json"))
        trace.write_jsonl(os.path.join(profile_dir,
                                       f"spans_{os.getpid()}.jsonl"))
        trace.reset()

    return profile(activities=activities, on_trace_ready=write)


def run_training(state: TrainState, step_fn: Callable,
                 make_batches: Callable[[np.random.Generator], Iterable[tuple]],
                 cfg: LoopConfig,
                 eval_fn: Callable[[TrainState], dict] | None = None
                 ) -> TrainState:
    """Drive ``step_fn`` over ``make_batches`` for ``cfg.epochs``.

    ``eval_fn`` (optional): called every ``cfg.eval_every`` steps with the
    current state; returns a metrics dict (dev loss/acc) that is logged and
    appended to the JSONL stream under ``eval_*`` keys.  Returns the state
    (the same object, updated in place)."""
    ckpt = Checkpointer(cfg.ckpt_dir) if cfg.ckpt_dir else None
    start_epoch = start_batch = 0
    if ckpt and cfg.resume == "auto":
        before = state.step
        state, start_epoch, start_batch = ckpt.restore_with_position(state)
        if ckpt.latest_step is not None:
            LOG.info("resumed from checkpoint at step %d (was %d; epoch %d, "
                     "batch %d)", state.step, before, start_epoch,
                     start_batch)
    if cfg.mesh is not None:
        # every rank starts from one state: equal seeds, or the one
        # checkpoint rank 0 named
        replicate(state.named_tensors(), cfg.mesh, "the train state")

    # artifact writes (the metrics JSONL here; checkpoint saves gate
    # themselves) happen on the main process only: N ranks sharing a model
    # dir must not interleave one stream
    metrics_f = None
    if cfg.metrics_path and is_main_process():
        os.makedirs(os.path.dirname(os.path.abspath(cfg.metrics_path)),
                    exist_ok=True)
        metrics_f = open(cfg.metrics_path, "a", encoding="utf-8")

    if cfg.early_stop and (eval_fn is None or not cfg.eval_every):
        # the eval hook can be absent even when requested (missing dev
        # split) — say so instead of silently training to the epoch cap
        LOG.warning("--early_stop %d requested but no dev eval will run "
                    "(eval hook unavailable or --eval_every 0) — training "
                    "runs to the epoch cap", cfg.early_stop)
    try:
        with profile_trace(cfg.profile_dir):
            state = _run(state, step_fn, make_batches, cfg, eval_fn, ckpt,
                         start_epoch, start_batch, metrics_f)
    finally:
        if metrics_f:
            metrics_f.close()
    return state


def _run(state, step_fn, make_batches, cfg, eval_fn, ckpt, start_epoch,
         start_batch, metrics_f) -> TrainState:
    # epoch rngs are STATELESS in (seed, epoch): a resumed run replays the
    # exact shuffle schedule of an uninterrupted one, so restoring (epoch,
    # batch_in_epoch) and skipping already-trained batches makes
    # kill-anywhere resume bit-reproducible (tests/test_torch_loop.py kills
    # mid-epoch with shuffling on).  Skip-aware generators never BUILD the
    # skipped batches; others fall back to iterate-and-drop.
    supports_skip = "skip" in inspect.signature(make_batches).parameters
    t_last = time.perf_counter()
    ex_since = 0
    # host-side mirror of state.step: every step_fn increments it by
    # exactly 1, and reading anything of the device each iteration would
    # stall the queue of launches; the device is only waited for at
    # log/eval/checkpoint points
    step = int(state.step)
    save_stall, n_saves = 0.0, 0   # loop-visible checkpoint-save wall
    best_eval = float("inf")
    best_state = None      # host copy of the best-eval state
    stale_evals = 0
    stop_early = False
    t_loop, first_step = time.perf_counter(), step
    reduced0 = dict(dist_mesh.REDUCE_STATS)
    for epoch in range(start_epoch, cfg.epochs):
        epoch_rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, epoch]))
        skip = start_batch if epoch == start_epoch else 0
        if supports_skip:
            gen = make_batches(epoch_rng, skip=skip)
            batch_in_epoch = skip
        else:
            gen = make_batches(epoch_rng)
            batch_in_epoch = 0
        for args in prefetch(gen):
            batch_in_epoch += 1
            if not supports_skip and batch_in_epoch <= skip:
                continue
            metrics = step_fn(state, *args)
            step += 1
            ex_since += 1
            if step % cfg.log_every == 0:
                # examples/sec is advisory: sampling THIS batch's valid
                # count (x steps since last log) happens where the loss
                # read already waits for the device
                loss = float(metrics["loss"])
                acc = float(metrics.get("acc", np.nan))
                now = time.perf_counter()
                rate = _global_examples(args, cfg.mesh) * ex_since / max(
                    now - t_last, 1e-9)
                t_last, ex_since = now, 0
                LOG.info("epoch %d step %d loss %.4f acc %.3f (%.0f ex/s)",
                         epoch, step, loss, acc, rate)
                if metrics_f:
                    metrics_f.write(json.dumps(
                        {"epoch": epoch, "step": step, "loss": loss,
                         "acc": acc, "examples_per_sec": rate}) + "\n")
                    metrics_f.flush()
            if (eval_fn is not None and cfg.eval_every
                    and step % cfg.eval_every == 0):
                ev = {k: float(v) for k, v in eval_fn(state).items()}
                LOG.info("epoch %d step %d EVAL %s", epoch, step,
                         " ".join(f"{k} {v:.4f}" for k, v in ev.items()))
                if metrics_f:
                    metrics_f.write(json.dumps(
                        {"epoch": epoch, "step": step,
                         **{f"eval_{k}": v for k, v in ev.items()}})
                        + "\n")
                    metrics_f.flush()
                if cfg.early_stop:
                    if ev.get("loss", float("inf")) < best_eval:
                        best_eval, stale_evals = ev["loss"], 0
                        # restore-best: a host copy, not a checkpoint —
                        # improvements can be frequent
                        best_state = host_copy(state)
                    else:
                        stale_evals += 1
                        if stale_evals >= cfg.early_stop:
                            LOG.info(
                                "early stop at step %d: eval loss has "
                                "not improved for %d eval(s) "
                                "(best %.4f)", step, stale_evals,
                                best_eval)
                            stop_early = True
                            break
            if ckpt and cfg.ckpt_every and step % cfg.ckpt_every == 0:
                t_save = time.perf_counter()
                ckpt.save(state, epoch=epoch,
                          batch_in_epoch=batch_in_epoch)
                dt_save = time.perf_counter() - t_save
                save_stall += dt_save
                n_saves += 1
                LOG.info("checkpoint save at step %d: loop stalled "
                         "%.0f ms", step, dt_save * 1e3)
        if stop_early:
            break
    if step > first_step:
        device = next(state.model.parameters()).device
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the queued steps, then the clock
        dt = max(time.perf_counter() - t_loop, 1e-9)
        LOG.info("training loop: %d steps in %.2f s (%.2f steps/s), evals "
                 "and checkpoint saves included", step - first_step, dt,
                 (step - first_step) / dt)
    if stop_early and best_state is not None:
        # restore-best: the state at the best dev loss, not the
        # stale-by-N-evals tail the stop condition just rejected
        LOG.info("early stop: restoring best-eval state (step %d, "
                 "loss %.4f)", best_state["step"], best_eval)
        load_into(state, best_state)
    if cfg.mesh is not None and step > first_step:
        # before anything is saved as the run's result: the ranks ran the
        # same updates on the same sums, so their states are one state
        replicate(state.named_tensors(), cfg.mesh, "the trained state")
    if n_saves:
        LOG.info("periodic checkpoint saves: %d, total loop-visible "
                 "stall %.2f s", n_saves, save_stall)
    reduced = {k: v - reduced0[k]
               for k, v in dist_mesh.REDUCE_STATS.items()}
    if reduced["calls"] and step > first_step:
        # two collectives a step: four sums of the loss, then the gradients
        LOG.info("all-reduce (%s): %d calls, %.3f ms and %.0f bytes a step "
                 "over %d steps, evals included",
                 dist_mesh.reduce_backend(), reduced["calls"],
                 reduced["seconds"] * 1e3 / (step - first_step),
                 reduced["bytes"] / (step - first_step), step - first_step)
    if ckpt:
        if stop_early and best_state is not None:
            # prune checkpoints past the best step — otherwise predict
            # and resume would pick the newer (worse) latest_step
            ckpt.wait()
            for s_ in ckpt.all_steps():
                if s_ > int(state.step):
                    ckpt.delete(s_)
        # end-of-training marker: resume would start past the last epoch
        # (force: a periodic save may already exist at this exact step)
        ckpt.save(state, wait=True, epoch=cfg.epochs, batch_in_epoch=0,
                  force=True)
        ckpt.close()
    return state


def host_copy(state: TrainState) -> dict:
    """Model, Adam state, step and seed as CPU tensors that share nothing
    with the live state (``load_into`` puts them back)."""
    return {**to_host(snapshot(state)), "step": int(state.step),
            "seed": int(state.seed)}


def _global_examples(args: tuple, mesh: Mesh | None) -> int:
    """The valid examples of the GLOBAL batch: this rank's count, summed
    over the ranks on the control group (every rank logs at the same
    steps, so the collective lines up); the ranks of one data row hold
    the same rows and count once."""
    n = _batch_examples(args)
    if mesh is None or dist_mesh.process_count() == 1:
        return n
    import torch.distributed as dist

    total = torch.tensor([n], dtype=torch.int64)
    dist.all_reduce(total)
    return int(total) // mesh.model


def _batch_examples(args: tuple) -> int:
    """Best-effort example count for throughput logging."""
    for a in args:
        if isinstance(a, dict):
            for key in ("pair_valid", "grid_valid"):
                if key in a:
                    return int(a[key].sum())
        elif getattr(a, "dtype", None) in (bool, torch.bool):
            return int(a.sum())
    return 0
