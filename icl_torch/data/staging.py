"""A batch's copy to the device, and the pinned host slabs the image
batchers pad into.

:func:`stage` is the one staging function of the process: the task CLIs'
``to_device`` (:func:`icl_torch.cli._common.to_device`) and the mesh's
``shard_batch_local`` and ``shard_batch`` (:mod:`icl_torch.dist.mesh`)
reach it.  It puts a tree of host arrays (dicts, tuples and lists of numpy
arrays or host tensors) on a device, as span ``h2d``
(:mod:`icl_torch.util.trace`), by one of two paths:

* The arrays of a dict that all lie in one slab of the :class:`SlabPool`
  (the relation and affinity batchers' fields) go in one ``non_blocking``
  copy of the slab's used bytes into one device buffer; the fields come
  back as typed views of it, with the shapes and strides fresh tensors
  would have, every one at a multiple of :data:`ALIGN` bytes.  An event
  recorded after the copy tells the pool when the slab's bytes have left
  (counter ``h2d.slab``, one a batch so staged).
* Every other array is copied alone: on CUDA pinned afresh
  (``pin_memory``, span ``h2d.pin``) and copied ``non_blocking``, elsewhere
  with ``.to``.  So go the mention tasks' tuples, the rows a process cuts
  out of a whole batch (``shard_batch``), a bf16 box block (a host tensor
  of its own) and everything on the CPU.

The pool (:data:`POOL`) hands out page-locked host buffers, allocated once
and reused across batches, one a batch, carved into the batch's fields.
It engages in a process once that process has staged something onto a
CUDA device; before that, and in every process that never does, the
batchers pad into fresh ``np.zeros`` arrays as they always did.  Slab sizes
are powers of two (at least :data:`SMALLEST` bytes), so the batches of
every bucket key share a few slabs; a request takes the smallest free slab
that holds it, and a new slab of its own class where none is free.  A slab
is handed out again only when both hold:

* no host view of it is alive: the pool keeps a weak reference to the
  numpy array its fields view, so a caller that keeps a batch's arrays
  (a check that reads them later, a sweep that keeps the batch until its
  answers come back) never finds them rewritten;
* the event recorded after its last copy has completed.

Past :data:`CAP` pinned bytes the pool hands out nothing more, and the
batch is padded into fresh arrays.  Counters: ``h2d.slab_alloc``, one a
slab allocated, and ``h2d.slab_alloc_bytes``, its bytes.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable

import numpy as np
import torch

from icl_torch.util import trace

ALIGN = 256          # each field's offset in its slab, in bytes
SMALLEST = 1 << 16   # the smallest slab
CAP = 1 << 30        # the pool's pinned bytes at most


class Slab:
    """One pinned host buffer of the pool."""

    __slots__ = ("buf", "ptr", "host", "event")

    def __init__(self, buf: torch.Tensor):
        self.buf = buf                 # uint8, its whole size class
        self.ptr = buf.data_ptr()
        self.host = None               # weakref to the numpy array handed out
        self.event = None              # recorded after its last copy

    def idle(self) -> bool:
        return ((self.host is None or self.host() is None)
                and (self.event is None or self.event.query()))


def _pinned(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class SlabPool:
    """Reused host slabs, one a batch (the module docstring).

    ``alloc(nbytes) -> uint8 tensor``: a new slab (page-locked memory by
    default); ``event() -> object with record() and query()``: what marks
    a slab's copy (a CUDA event by default)."""

    def __init__(self, alloc: Callable[[int], torch.Tensor] = _pinned,
                 event: Callable[[], Any] = torch.cuda.Event,
                 cap: int = CAP):
        self._alloc, self._event, self._cap = alloc, event, cap
        self._slabs: list[Slab] = []
        self._lock = threading.Lock()
        self.engaged = False
        self.bytes = 0

    def engage(self) -> None:
        """Hand out slabs from now on."""
        self.engaged = True

    def fields(self, specs) -> dict[str, np.ndarray] | None:
        """``specs``: ``(name, shape, dtype)`` of each field, laid out in
        that order at :data:`ALIGN`-byte offsets of one slab.  The fields
        as views of it, holding whatever the slab held last; None while the
        pool is not engaged or is full."""
        if not self.engaged:
            return None
        layout, end = [], 0
        for name, shape, dtype in specs:
            dtype = np.dtype(dtype)
            at = -(-end // ALIGN) * ALIGN
            end = at + int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            layout.append((name, shape, dtype, at, end))
        base = self._take(end)
        if base is None:
            return None
        return {name: base[at:stop].view(dtype).reshape(shape)
                for name, shape, dtype, at, stop in layout}

    def _take(self, nbytes: int) -> np.ndarray | None:
        """A slab of at least ``nbytes``, marked as handed out: the numpy
        array of its bytes that the fields will view."""
        size = max(SMALLEST, 1 << (nbytes - 1).bit_length())
        with self._lock:
            free = [s for s in self._slabs
                    if s.buf.numel() >= size and s.idle()]
            if free:
                slab = min(free, key=lambda s: s.buf.numel())
            elif self.bytes + size > self._cap:
                return None
            else:
                slab = Slab(self._alloc(size))
                self._slabs.append(slab)
                self.bytes += size
                trace.count("h2d.slab_alloc")
                trace.count("h2d.slab_alloc_bytes", size)
            base = slab.buf.numpy()
            slab.host = weakref.ref(base)
        return base

    def find(self, arrays: dict) -> tuple[Slab, dict] | None:
        """The slab the numpy arrays of ``arrays`` view, with each such
        array's offset in it (``{name: offset}``); None where none does.
        Arrays that view another buffer are left out."""
        if not self._slabs:
            return None
        slab, base, where = None, None, {}
        for name, x in arrays.items():
            if not (isinstance(x, np.ndarray) and x.base is not None
                    and x.flags.c_contiguous):
                continue
            if slab is None:
                slab = self._holding(x.base)
                base = x.base
            if slab is not None and x.base is base:
                where[name] = x.__array_interface__["data"][0] - slab.ptr
        return (slab, where) if where else None

    def _holding(self, obj) -> Slab | None:
        with self._lock:
            for s in self._slabs:
                if s.host is not None and s.host() is obj:
                    return s
        return None

    def copied(self, slab: Slab) -> None:
        """Mark the copy just queued from ``slab`` on the current stream."""
        if slab.event is None:
            slab.event = self._event()
        slab.event.record()


# the process's pool: the batchers pad into it, :func:`stage` copies from it
POOL = SlabPool()


def zeros(specs) -> tuple[dict[str, np.ndarray], bool]:
    """A batch's fields (``(name, shape, dtype)`` each): views of one slab
    of :data:`POOL`, holding what it held last, and False; or, where the
    pool hands out none, fresh ``np.zeros`` arrays and True."""
    got = POOL.fields(specs)
    if got is not None:
        return got, False
    return {name: np.zeros(shape, dtype) for name, shape, dtype in specs}, True


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _to_device(x, device: torch.device) -> torch.Tensor:
    """One array on ``device``: on CUDA pinned afresh, then copied
    ``non_blocking``."""
    if device.type != "cuda" or (isinstance(x, torch.Tensor)
                                 and x.device.type == "cuda"):
        return _as_tensor(x).to(device)
    with trace.span("h2d.pin"):
        t = _as_tensor(x).pin_memory()
    return t.to(device, non_blocking=True)


def _one_copy(pool: SlabPool, arrays: dict, slab: Slab, where: dict,
              device: torch.device) -> dict:
    """The arrays at ``where`` in ``slab`` as typed views of one device
    buffer, filled by one copy of the slab's bytes up to the last of
    them."""
    used = max(off + arrays[k].nbytes for k, off in where.items())
    dev = torch.empty(used, dtype=torch.uint8, device=device)
    dev.copy_(slab.buf[:used], non_blocking=True)
    pool.copied(slab)
    trace.count("h2d.slab")
    out = {}
    for k, off in where.items():
        x = arrays[k]
        out[k] = dev[off:off + x.nbytes].view(
            torch.from_numpy(x).dtype).view(x.shape)
    return out


def _pinned_pool(device: torch.device) -> tuple[int, int]:
    """(allocations, their microseconds) of PyTorch's pinned host-memory
    pool so far; zeros off CUDA."""
    if device.type != "cuda":
        return 0, 0
    s = torch.cuda.memory.host_memory_stats()
    return (int(s.get("num_host_alloc", 0)),
            int(s.get("host_alloc_time.total", 0)))


def stage(tree: Any, device: torch.device,
          cut: Callable | None = None) -> Any:
    """``tree`` (dicts, tuples and lists of host arrays) as tensors on
    ``device``, as span ``h2d`` (the module docstring); ``cut(x)``, where
    given, the part of each array to copy, each alone.  The span's
    attributes: the bytes and arrays put on the device and, where this
    thread sees the profile (not on a prefetch worker), how much PyTorch's
    pinned pool grew meanwhile (``pool_allocs``, ``pool_alloc_us``: its
    ``cudaHostAlloc`` calls and their time)."""
    pool = POOL
    if device.type == "cuda":
        pool.engage()
    sizes = []

    def one(x):
        t = _to_device(x if cut is None else cut(x), device)
        sizes.append(t.numel() * t.element_size())
        return t

    def walk(t):
        if isinstance(t, dict):
            found = pool.find(t) if cut is None else None
            if found is None:
                return {k: walk(v) for k, v in t.items()}
            views = _one_copy(pool, t, *found, device)
            sizes.extend(v.numel() * v.element_size() for v in views.values())
            return {k: views[k] if k in views else walk(v)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return one(t)

    with trace.span("h2d") as sp:
        if not sp:
            return walk(tree)
        host_pool = _pinned_pool(device) if trace.enabled() else None
        out = walk(tree)
        sp.set(bytes=sum(sizes), arrays=len(sizes))
        if host_pool is not None:
            after = _pinned_pool(device)
            sp.set(pool_allocs=after[0] - host_pool[0],
                   pool_alloc_us=after[1] - host_pool[1])
        return out
