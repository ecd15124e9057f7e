"""Checkpoint and resume (counterpart of ``icl/train/checkpoint.py``).

The *full* train state is saved every N steps: the model's ``state_dict``,
Adam's ``state_dict``, ``TrainState.step`` and ``seed``, and the loop
position (epoch, batch_in_epoch), with ``torch.save`` into
``<dir>/step_<n>.pt``.  ``--resume auto`` restores the newest one, so a
killed run continues exactly (``tests/test_torch_loop.py``).  Two properties
of the reference are kept:

* a save is **atomic**: the payload is written to a temporary name in the
  same directory, flushed, and renamed onto ``step_<n>.pt`` with
  ``os.replace``.  A kill at any point leaves the previous checkpoints
  readable; what it leaves of the temporary file is swept by the next save
  (a reader never deletes: a predict may run beside a training run);
* a periodic save **overlaps training**: :func:`snapshot` copies the state
  into fresh device tensors on the current stream (the optimizer updates
  the live ones in place at the next step), and one background thread does
  the device-to-host copy (on its own stream, behind an event) and the
  write.  Every other method joins that thread first and re-raises what it
  raised, so ``latest_step``, ``all_steps`` and durability after ``wait``
  are those of synchronous saves.

More than one process (a ``torch.distributed`` group is up): EVERY rank
calls :meth:`Checkpointer.save`, ``restore`` and the listing methods at the
same points, and rank 0 is the single writer.  A save is then synchronous
(a collective from a background thread could interleave with the train
step's collectives differently on each rank) and ends in a barrier; the
listing (``latest_step``, ``all_steps``) is rank 0's, broadcast, never each
rank's own view of the directory, so ``--resume auto`` restores one step on
every rank; what rank 0 fails at raises on every rank.  The model dir must
be on storage all ranks can read.
"""

from __future__ import annotations

import os
import re
import threading

import torch

from icl_torch.dist.mesh import (is_main_process, on_main, process_count,
                                 sync_processes)
from icl_torch.train.state import TrainState

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
_TMP_PREFIX = ".tmp_step_"


def _map_tensors(tree, fn):
    """``tree`` with ``fn`` applied to every tensor in its dicts and lists."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def snapshot(state: TrainState) -> dict:
    """The model's and the optimizer's ``state_dict`` copied into FRESH
    tensors on their device, on the current stream: decouples a later
    device-to-host copy from the in-place updates of the next steps."""
    def fresh(t):
        return t.detach().clone()

    return {"model": _map_tensors(state.model.state_dict(), fresh),
            "optimizer": _map_tensors(state.optimizer.state_dict(), fresh)}


def to_host(tree: dict) -> dict:
    """A :func:`snapshot` (or live ``state_dict``s) as CPU tensors.  CUDA
    tensors go through pinned memory on the current stream, which is
    synchronised before returning."""
    on_cuda = []

    def pull(t):
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        on_cuda.append(t.device)
        return host

    out = _map_tensors(tree, pull)
    for dev in set(on_cuda):
        torch.cuda.current_stream(dev).synchronize()
    return out


def load_into(state: TrainState, payload: dict) -> None:
    """Copy a payload (``model``, ``optimizer``, ``step``, ``seed``) into
    the live state, in place; the tensors land on the state's device.

    Adam's groups keep the live ``capturable``: a state that ran the CUDA
    graphs (:mod:`icl_torch.train.graphs`) saves it on, which Adam on the
    CPU, or eager under a process group, cannot step with."""
    state.model.load_state_dict(payload["model"])
    saved = payload["optimizer"]
    groups = [{**g, "capturable": live.get("capturable", False)} for g, live
              in zip(saved["param_groups"], state.optimizer.param_groups,
                     strict=True)]
    state.optimizer.load_state_dict({**saved, "param_groups": groups})
    state.step = int(payload["step"])
    state.seed = int(payload["seed"])


class Checkpointer:
    """Step-keyed checkpoints of a :class:`TrainState` under one directory;
    the newest ``max_to_keep`` are kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if is_main_process():       # the single writer makes the directory
            os.makedirs(self.directory, exist_ok=True)
        self._inflight: threading.Thread | None = None
        self._inflight_exc: BaseException | None = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def _local_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in
                      map(_STEP_FILE.match, os.listdir(self.directory)) if m)

    def _steps(self) -> list[int]:
        """The steps on disk, as rank 0 sees them."""
        return on_main(self._local_steps, f"listing {self.directory}")

    def _join(self) -> None:
        t = self._inflight
        if t is not None:
            t.join()
            self._inflight = None
            if self._inflight_exc is not None:
                exc, self._inflight_exc = self._inflight_exc, None
                raise exc

    def _write(self, step: int, payload: dict) -> None:
        for name in os.listdir(self.directory):   # a killed save's leavings
            if name.startswith(_TMP_PREFIX):
                os.unlink(os.path.join(self.directory, name))
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{step}.{os.getpid()}")
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._path(step))
        for old in self._local_steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def save(self, state: TrainState, wait: bool = False,
             epoch: int = 0, batch_in_epoch: int = 0,
             force: bool = False) -> None:
        """Save ``state`` under its step.  Periodic saves (neither ``wait``
        nor ``force``) return once the state is copied on the device; the
        pull and the write run in the background.  ``force`` replaces an
        existing checkpoint of the same step (the end-of-training marker
        when a periodic save landed on it); without it that is an error."""
        self._join()
        step = int(state.step)
        meta = {"step": step, "seed": int(state.seed), "epoch": int(epoch),
                "batch_in_epoch": int(batch_in_epoch)}

        def refuse_existing():
            if not force and os.path.exists(self._path(step)):
                raise FileExistsError(f"checkpoint step {step} exists in "
                                      f"{self.directory}; pass force=True "
                                      f"to replace it")

        def write_live():
            # synchronous: the pull finishes before any later step can
            # touch the live tensors, so no device copy is needed
            refuse_existing()
            live = {"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()}
            self._write(step, {**to_host(live), **meta})

        if process_count() > 1:
            on_main(write_live, f"checkpoint save at step {step}")
            sync_processes(f"checkpoint save at step {step}")
            return
        if wait or force:
            write_live()
            return
        refuse_existing()
        snap = snapshot(state)
        device = next(state.model.parameters()).device
        ready = None
        if device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(device))

        def pull_and_write():
            try:
                if ready is None:
                    self._write(step, {**snap, **meta})
                    return
                side = torch.cuda.Stream(device)
                side.wait_event(ready)
                with torch.cuda.stream(side):
                    host = to_host(snap)
                self._write(step, {**host, **meta})
            except BaseException as e:   # re-raised at the next _join
                self._inflight_exc = e

        t = threading.Thread(target=pull_and_write, daemon=True,
                             name="icl-ckpt-pull")
        t.start()
        self._inflight = t

    def load_weights(self, step: int | None = None) -> tuple[dict, int]:
        """The model's weights in one checkpoint, the newest unless ``step``
        names another -> (``icl-export`` key -> CPU tensor, step).  What
        the export and the server read of a model dir; a missing step names
        the steps there are."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoint steps under "
                                    f"{self.directory}")
        if step is None:
            step = steps[-1]
        elif step not in steps:
            raise ValueError(f"step {step} not in checkpoints {steps} under "
                             f"{self.directory}")
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        return ({k.replace(".", "/"): v
                 for k, v in payload["model"].items()}, step)

    def save_payload(self, step: int, payload: dict) -> None:
        """Write a ready payload (``model``, ``optimizer``, ``step``,
        ``seed``, ``epoch``, ``batch_in_epoch``; CPU tensors) as
        ``step_<step>.pt``, atomically: how ``icl-torch-import`` writes a
        checkpoint without a live state."""
        self._join()
        self._write(int(step), payload)

    @property
    def latest_step(self) -> int | None:
        self._join()
        steps = self._steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        self._join()
        return self._steps()

    def delete(self, step: int) -> None:
        """Drop one checkpoint (used to prune the stale tail past the
        best-eval step when early stopping restores the best weights)."""
        self._join()
        on_main(lambda: os.unlink(self._path(step)),
                f"deleting checkpoint step {step}")

    def restore(self, state: TrainState) -> TrainState:
        """Restore the newest checkpoint into the (freshly initialised)
        state, in place; the state as it is when there is none."""
        state, _, _ = self.restore_with_position(state)
        return state

    def restore_with_position(self, state: TrainState):
        """Like :meth:`restore`, also returning (epoch, batch_in_epoch)."""
        step = self.latest_step
        if step is None:
            return state, 0, 0
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        load_into(state, payload)
        return (state, int(payload.get("epoch", 0)),
                int(payload.get("batch_in_epoch", 0)))

    def wait(self) -> None:
        self._join()

    def close(self) -> None:
        self._join()
