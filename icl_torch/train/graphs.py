"""The image train step as one CUDA graph per batch key.

On CUDA, outside a process group, the relation and affinity train steps
(:func:`icl_torch.train.steps.make_relation_train_step`,
``make_affinity_train_step``) capture the whole step, the loss,
``loss.backward()`` and Adam, in one CUDA graph per batch key
(:func:`batch_key`), and replay it: one launch a step in place of some
hundred eager launches, each with its Python.  The hand-written kernels are
in the graph as they are.

* The first step on a train state is eager, as the step runs without
  graphs.  It creates Adam's state and every parameter's ``.grad`` and
  loads the kernels' libraries; then Adam's ``capturable`` mode goes on
  (its step count on the device; the same betas, eps and formula, rounded
  otherwise in the last bits).  Where Adam has state already (a
  checkpoint restored into it, which keeps the live mode), the mode goes
  on before that eager step, so a resumed run steps as the run it resumes.  Every graph zeroes and accumulates into
  those same ``.grad`` buffers, so after any step they hold that step's
  gradients; the captures share one memory pool.
* A key seen for the first time is captured (``capture_error_mode=
  "thread_local"``: the prefetch worker goes on copying meanwhile), then
  replayed for the batch that brought it; a capture runs nothing, so every
  step is computed once.  A capture that fails (a host sync inside the
  step) leaves its key eager, logged and counted once.
* A replay copies the batch into the key's static tensors, and the step's
  dropout seeds, drawn on the host as the eager step draws them, through
  pinned memory into the key's seed tensor; the metrics come back as fresh
  tensors, so a caller's earlier metrics are never overwritten.
* The wrappers count their launches in Python, which a replay does not run:
  the launches and trace counts (``lstm.bwd.kernel``) that a capture makes
  go to its :func:`~icl_torch.util.trace.tape`, and every replay makes
  them again.
* Counters (:mod:`icl_torch.util.trace`): ``train.graph.capture`` a key
  captured, ``train.graph.replay`` a replayed step, ``train.graph.fallback``
  a key that stays eager.  A replay has no host phases to time: the spans
  ``train.forward``, ``train.backward``, ``train.optimizer`` and
  ``lstm.backward`` are the eager step's.

A state other than the one the graphs were made on, or one whose Adam
state or ``.grad`` buffers were replaced since (a checkpoint restored into
it, ``zero_grad(set_to_none=True)``), starts over from an eager step.
"""

from __future__ import annotations

import warnings
import weakref

import torch

from icl_torch.util import trace
from icl_torch.util.log import LOG

_MISSING = object()


def graphable(table: torch.Tensor) -> bool:
    """Whether the graphed step takes a call made outside a process group:
    the word table on CUDA."""
    return table.device.type == "cuda"


def batch_key(table: torch.Tensor, batch: dict) -> tuple:
    """What a capture fixes that may differ between calls: each batch
    tensor's name, shape and dtype; the word table's shape, dtype, strides
    and address (the graph reads it where it lies)."""
    return (tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items()),
            (tuple(table.shape), table.dtype, table.stride(),
             table.data_ptr()))


def _params(opt: torch.optim.Optimizer) -> list:
    return [p for group in opt.param_groups for p in group["params"]]


def make_capturable(opt: torch.optim.Optimizer) -> None:
    """Turn the optimizer's ``capturable`` mode on, its step counts moved
    to the parameters' device (where an eager step, or a checkpoint of
    one, keeps them on the host)."""
    for group in opt.param_groups:
        group["capturable"] = True
    for p, st in opt.state.items():
        if isinstance(st.get("step"), torch.Tensor):
            st["step"] = st["step"].to(p.device)


class _Graph:
    """One key's graph, its static inputs and outputs, and the counts and
    launches its capture made."""

    __slots__ = ("graph", "batch", "seeds", "metrics", "counts")


class _StateGraphs:
    """The graphs made on one train state, and what they hold on to."""

    def __init__(self, state):
        opt = state.optimizer
        self.state = weakref.ref(state)
        self.opt_state = opt.state
        self.grads = [(p, p.grad) for p in _params(opt)]
        self.pool = torch.cuda.graph_pool_handle()
        # the captures' own stream, from PyTorch's pool of high-priority
        # streams: a stream of the default pool, which hands its streams
        # out in turn, may at the same time serve another thread (a
        # checkpoint's pull), whose work would then join the capture
        self.stream = torch.cuda.Stream(self.grads[0][0].device, priority=-1)
        self.graphs: dict = {}

    def serves(self, state) -> bool:
        opt = state.optimizer
        return (self.state() is state and opt.state is self.opt_state
                and all(p.grad is g for p, g in self.grads))


class GraphedStep:
    """``step(state, table, batch) -> metrics`` through CUDA graphs (the
    module docstring).

    ``eager(state, table, batch)``: the step run eagerly, zeroing the
    ``.grad`` buffers in place; ``loss(state, table, batch, seeds) ->
    (loss, metrics)``: its loss; ``images_key``: the batch tensor whose
    rows are the images, one dropout seed each."""

    def __init__(self, eager, loss, images_key: str):
        self.eager, self.loss, self.images_key = eager, loss, images_key
        self._on: _StateGraphs | None = None

    def __call__(self, state, table: torch.Tensor, batch: dict) -> dict:
        on = self._on
        if on is None or not on.serves(state):
            return self._first(state, table, batch)
        key = batch_key(table, batch)
        g = on.graphs.get(key, _MISSING)
        if g is _MISSING:
            g = on.graphs[key] = self._capture(on, state, table, batch, key)
        if g is None:
            return self.eager(state, table, batch)
        return self._replay(g, state, batch)

    def _first(self, state, table, batch) -> dict:
        self._on = None
        opt = state.optimizer
        if opt.state:   # Adam has stepped (or was restored): as the graphs
            make_capturable(opt)
        with warnings.catch_warnings():     # capturable, outside a capture
            warnings.filterwarnings("ignore", message=".*capturable=True")
            metrics = self.eager(state, table, batch)
        make_capturable(opt)
        for p in _params(state.optimizer):
            if p.grad is None:      # as under a mesh: it adds zeros
                p.grad = torch.zeros_like(p)
        self._on = _StateGraphs(state)
        return metrics

    def _capture(self, on, state, table, batch, key) -> _Graph | None:
        g = _Graph()
        g.batch = {k: v.clone() for k, v in batch.items()}
        g.seeds = torch.zeros(batch[self.images_key].shape[0],
                              dtype=torch.int32, device=table.device)
        g.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream()
        try:
            with trace.tape() as g.counts, torch.cuda.graph(
                    g.graph, pool=on.pool, stream=on.stream,
                    capture_error_mode="thread_local"):
                torch._foreach_zero_([grad for _, grad in on.grads])
                loss, metrics = self.loss(state, table, g.batch, g.seeds)
                loss.backward()
                state.optimizer.step()
        except RuntimeError as e:
            torch.cuda.set_stream(stream)
            LOG.warning("train step: the batch key %s stays eager, its CUDA "
                        "graph capture failed: %s", key[0], e)
            trace.count("train.graph.fallback")
            return None
        g.metrics = {k: v.detach() for k, v in metrics.items()}
        trace.count("train.graph.capture")
        return g

    def _replay(self, g: _Graph, state, batch: dict) -> dict:
        for k, v in g.batch.items():
            v.copy_(batch[k])
        seeds = torch.from_numpy(state.host_dropout_seeds(len(g.seeds)))
        g.seeds.copy_(seeds.pin_memory(), non_blocking=True)
        g.graph.replay()
        state.step += 1
        trace.replay(g.counts)
        trace.count("train.graph.replay")
        return {k: v.clone() for k, v in g.metrics.items()}
