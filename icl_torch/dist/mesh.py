"""The process mesh and the collectives of data parallelism (counterpart of
``icl/dist/mesh.py``, on ``torch.distributed``).

One process drives one device, so the data axis of the mesh is a list of
ranks: ``Mesh(data, model, rank, world)``.  Parameters and Adam state are
replicated (every rank makes them from the same seed); a batch is sharded by
rows: rank ``r`` sits in data row ``r // model`` and feeds the rows
:func:`local_data_rows` names.  The model axis is plumbed and unused: the
ranks of one data row hold the same rows and compute the same sums, and
:func:`all_reduce_sum` counts one of them.

Nothing sums gradients implicitly here.  The train steps
(:mod:`icl_torch.train.steps`) and the eval hooks call
:func:`all_reduce_sum` over one flat buffer.  It runs on the *reduce group*
that :func:`icl_torch.runtime.init` chose (NCCL when every rank has a GPU of
its own, else gloo through a pinned host buffer).  Barriers, outcome
exchanges and everything else that moves Python objects run on the *control
group*, which is gloo on CPU tensors always.  Every collective is issued
from the main thread.

Topology strings: ``"1"``/``"8"`` (data only), ``"4x2"`` (data x model).
Without an initialised process group every function here is the
single-process identity: world 1, rank 0, nothing is communicated.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from icl_torch.data.staging import stage
from icl_torch.util.log import LOG

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) grid over the first ``data * model`` ranks."""
    data: int
    model: int
    rank: int
    world: int

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_row(self) -> int:
        """The data-axis row this rank sits in."""
        return self.rank // self.model

    @property
    def counted(self) -> bool:
        """Whether this rank's sums enter a reduction: one rank of each data
        row does (model column 0); its row mates hold the same numbers."""
        return self.rank % self.model == 0


# what runtime.init chose for gradient and eval sums; None: the default
# (control) group, through the host
_reduce = {"group": None, "backend": None}
# all_reduce_sum's own account: calls, bytes moved per rank, host seconds
REDUCE_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def set_reduce_group(group, backend: str | None) -> None:
    """Name the group :func:`all_reduce_sum` runs on (``runtime.init``)."""
    _reduce["group"], _reduce["backend"] = group, backend


def reduce_backend() -> str | None:
    """``"nccl"``, ``"gloo"``, or None without a process group."""
    return _reduce["backend"] if dist.is_initialized() else None


def build_mesh(topology: str | None = None) -> Mesh:
    """Build a (data, model) mesh from a topology string.

    ``None``/``"auto"`` -> every rank on the data axis.  ``"DxM"`` ->
    explicit data x model grid; ``"D"`` -> D data-parallel ranks, model=1.
    """
    world = process_count()
    if topology is None or topology == "auto":
        d, m = world, 1
    elif "x" in topology:
        d_str, m_str = topology.split("x", 1)
        d, m = int(d_str), int(m_str)
    else:
        d, m = int(topology), 1
    if d * m > world:
        raise ValueError(f"topology {d}x{m} needs {d*m} devices, "
                         f"have {world}")
    return Mesh(data=d, model=m, rank=process_index(), world=world)


def data_axis_size(mesh: Mesh) -> int:
    return mesh.data


def is_main_process() -> bool:
    """True on the process that owns run artifacts (checkpoints, metrics,
    config dumps).  Single-process runs are always main; under a group
    exactly one rank writes, so N processes sharing a model dir cannot race
    each other."""
    return process_index() == 0


def local_data_rows(mesh: Mesh, global_rows: int) -> tuple[int, int]:
    """Contiguous [lo, hi) global-batch rows owned by THIS process: the
    block of its data row.  Every rank builds only these rows of the
    (rng-deterministic, globally agreed) batch schedule."""
    d = mesh.data
    if global_rows % d:
        raise ValueError(f"global batch {global_rows} not divisible by "
                         f"data axis {d}")
    if mesh.data_row >= d:
        raise ValueError("this process owns no data-axis rows on the mesh")
    per = global_rows // d
    return mesh.data_row * per, (mesh.data_row + 1) * per


def shard_batch_local(local_batch: Any, mesh: Mesh,
                      device: torch.device) -> Any:
    """THIS process's rows of a batch (those of :func:`local_data_rows`,
    already cut) as tensors on its device (:func:`icl_torch.data.staging
    .stage`: a batch padded into one slab in one copy)."""
    return stage(local_batch, device)


def shard_batch(batch: Any, mesh: Mesh, device: torch.device) -> Any:
    """Cut this rank's rows out of a whole host batch (dicts, tuples and
    lists of arrays whose leading axis is the batch) and copy them to the
    device, each array alone.  Single-process: all rows, as
    :func:`shard_batch_local`."""
    if process_count() == 1:
        return shard_batch_local(batch, mesh, device)

    def cut(x):
        lo, hi = local_data_rows(mesh, int(np.shape(x)[0]))
        return x[lo:hi]

    return stage(batch, device, cut)


# how far a rank's freshly made state may lie from rank 0's and still be
# taken for the same state: rounding of a host library (a threaded LAPACK
# or BLAS picks its blocking by the load it finds), relative to max(1,
# max |rank 0's|).  Anything beyond is another seed or another checkpoint.
REPLICA_NOISE = 1e-6


def replicate(tensors: Sequence[torch.Tensor] | Mapping[str, torch.Tensor],
              mesh: Mesh, what: str = "state") -> None:
    """Hold every rank to rank 0's tensors (parameters, Adam state).

    Every rank makes them from the same seed, or restores them from the
    checkpoint rank 0 names, so they are equal already; this checks it,
    once at start and after every restore: rank 0's values are broadcast
    and each rank compares its own bit for bit.  Ranks that differ by
    rounding alone (``REPLICA_NOISE``) take rank 0's values, in place, and
    every rank warns with the numbers; if any rank differs by more, every
    rank raises: a restore from a half-synced directory, or another seed,
    cannot go unnoticed.  Both name each tensor that differs, with its
    largest gap and how many of its values differ (``tensors`` given as a
    name -> tensor mapping, else by position).  Single-process: nothing
    to do."""
    if process_count() == 1 or not tensors:
        return
    if isinstance(tensors, Mapping):
        names, tensors = list(tensors), list(tensors.values())
    else:
        names = [f"tensor {i}" for i in range(len(tensors))]
    mine = torch.cat([t.detach().to("cpu", torch.float64).reshape(-1)
                      for t in tensors])
    ref = mine.clone()
    dist.broadcast(ref, src=0)
    gap = (mine - ref).abs()
    apart, at = {}, 0
    for name, t in zip(names, tensors):
        part = gap[at:at + t.numel()]
        at += t.numel()
        if part.numel() and not bool((part == 0).all()):   # NaN included
            apart[name] = (float(part.max()), int((part != 0).sum()))
    every = [None] * process_count()
    dist.all_gather_object(every, (float(gap.max()), apart))
    worst = float(torch.tensor([w for w, _ in every]).max())  # NaN wins
    if worst == 0.0:
        LOG.info("replicate: %s equal on all %d ranks (%d values)", what,
                 process_count(), mine.numel())
        return
    bad = [k for k, (_, named) in enumerate(every) if named]
    said = "; ".join(
        f"rank {k}: " + ", ".join(f"{n} {g:.3e} ({c} values)"
                                  for n, (g, c) in every[k][1].items())
        for k in bad)
    scale = max(1.0, float(ref.abs().max()))
    if not worst <= REPLICA_NOISE * scale:          # NaN fails too
        raise RuntimeError(
            f"{what} differs from rank 0's on rank(s) {bad} by up to "
            f"{worst:.3e} ({said}): the ranks must start from one seed and "
            f"restore one checkpoint (a model dir on storage every rank "
            f"sees)")
    LOG.warning("replicate: %s differs from rank 0's on rank(s) %s by up to "
                "%.3e (rounding: under %.0e of %.3g; %s); every rank takes "
                "rank 0's values", what, bad, worst, REPLICA_NOISE, scale,
                said)
    at = 0
    for t in tensors:
        n = t.numel()
        t.detach().copy_(ref[at:at + n].view_as(t))
        at += n


def all_reduce_sum(tensors: Sequence[torch.Tensor],
                   mesh: Mesh | None = None) -> None:
    """Sum ``tensors`` over the data axis, in place, through ONE flat
    buffer and one collective; every rank ends with the same bits.

    With a model axis the ranks of one data row hold equal numbers; only
    column 0's enter the sum (the others add zeros).  A rank with nothing
    to add (all rows padding) still calls this: its zeros are its share.
    NCCL reduces the device buffer in place; gloo reduces a pinned host
    copy of it (the same sum).  ``REDUCE_STATS`` counts calls, bytes and
    host seconds: the whole collective where it is staged or on the CPU,
    under NCCL only the time to queue it.  Single-process: nothing to do."""
    if not dist.is_initialized() or not tensors:
        return
    device = tensors[0].device
    staged = device.type == "cuda" and _reduce["backend"] != "nccl"
    if staged:
        # the host copy below waits for the device anyway; waiting first
        # keeps the kernels queued before it out of the collective's clock
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    if mesh is not None and not mesh.counted:
        flat.zero_()
    if staged:
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat)
        dist.all_reduce(host, group=_reduce["group"])
        flat.copy_(host)
    else:   # NCCL on the device buffer (queued on its stream), gloo on CPU
        dist.all_reduce(flat, group=_reduce["group"])
    at = 0
    for t in tensors:
        n = t.numel()
        t.detach().copy_(flat[at:at + n].view_as(t))
        at += n
    if staged:
        torch.cuda.synchronize(device)
    REDUCE_STATS["calls"] += 1
    REDUCE_STATS["bytes"] += flat.numel() * flat.element_size()
    REDUCE_STATS["seconds"] += time.perf_counter() - t0


def predict_mesh(mesh: Mesh) -> Mesh:
    """The mesh a `.scores` predict sweep runs on.

    Single-process: the mesh unchanged.  Multi-process: this rank alone on
    its own device: predict partitions *examples* across processes (each
    sweeps its own contiguous dataset slice independently, then process 0
    merges the part files), so the sweep needs no collective and a rank
    that finishes early stalls nobody."""
    if process_count() == 1:
        return mesh
    return Mesh(data=1, model=1, rank=mesh.rank, world=mesh.world)


def sweep_data_axis_size(mesh: Mesh, predict: bool) -> int:
    """Data-axis size this run's batch row counts must divide by: the
    mesh's for training, and 1 for a multi-process predict sweep, which runs
    on :func:`predict_mesh`."""
    if predict and process_count() > 1:
        return data_axis_size(predict_mesh(mesh))
    return data_axis_size(mesh)


def predict_partition(n: int, weights=None) -> tuple[int, int]:
    """Contiguous [lo, hi) slice of n dataset examples owned by THIS process.

    Deterministic balanced split in dataset order: process k's slice
    directly precedes process k+1's, so concatenating the per-process
    `.scores` part files in process order reproduces the single-process
    file's row ORDER exactly (the merge itself is byte-exact).

    ``weights`` (optional, len n): per-example sweep cost.  Relation and
    affinity "examples" are IMAGES whose pair/cell counts vary, so an
    equal-count split can leave one process sweeping far more rows than
    another, and the merge barrier waits on the slowest.  With weights,
    boundary k lands where the cumulative cost crosses k/p of the total
    (every process computes the same boundaries from the same dataset
    order).  Without weights: equal counts, remainder to the lowest ranks.
    """
    p, k = process_count(), process_index()
    if weights is not None and n > 0:
        cum = np.cumsum(np.asarray(weights, np.float64))
        assert cum.shape == (n,), (cum.shape, n)
        if cum[-1] > 0:
            targets = cum[-1] * np.arange(1, p) / p
            # +1: the example whose cumulative cost CROSSES target k joins
            # the earlier slice, so a single dominant example occupies its
            # own slice instead of pushing everything onto the last
            # process.  Boundaries stay monotone and <= n, so every slice
            # is a valid, possibly empty, range.
            bounds = np.searchsorted(cum, targets, side="left") + 1
            bounds = np.concatenate([[0], bounds, [n]]).astype(int)
            return int(bounds[k]), int(min(bounds[k + 1], n))
    base, rem = divmod(n, p)
    lo = k * base + min(k, rem)
    return lo, lo + base + (1 if k < rem else 0)


def sync_processes(key: str) -> None:
    """Cross-process barrier on the control group (no-op single-process).
    ``key`` names the point in the logs of a run that timed out."""
    if process_count() == 1:
        return
    try:
        dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {key!r}: {e}") from e


def on_main(fn: Callable[[], Any], what: str) -> Any:
    """Run ``fn`` on rank 0 alone and hand its (picklable) result to every
    rank; when it raises, every rank raises.  The broadcast is the point
    past which the other ranks may rely on what ``fn`` wrote."""
    if process_count() == 1:
        return fn()
    box = [None]
    err = None
    if is_main_process():
        try:
            box[0] = ("ok", fn())
        except BaseException as e:   # re-raised after the broadcast
            err = e
            box[0] = ("error", f"{type(e).__name__}: {e}")
    dist.broadcast_object_list(box, src=0)
    if err is not None:
        raise err
    kind, value = box[0]
    if kind == "error":
        raise RuntimeError(f"{what} failed on rank 0: {value}")
    return value


def gather_parts(path: str, tag: str, write_part, merge) -> Any:
    """Part-file scatter/gather for sharded multi-process outputs.

    One copy of the choreography both sharded-output merges share (the
    `.scores` byte merge and the ScoreDict count merge): every process
    writes its payload to ``<path>.<tag>-<k:05d>`` via
    ``write_part(part_path)``; after a barrier, process 0 calls
    ``merge(part_paths)`` over all parts in process order; a second barrier
    lets each process delete the part it owns (wrote).  Returns ``merge``'s
    result on process 0, ``None`` elsewhere.

    ``path`` must live on storage visible to every process (the same
    contract the checkpoint directory carries); without it, process 0's
    merge fails loudly with the missing part path.  FAILURES in either
    phase are handled so no rank ever stops participating in a collective
    its peers are waiting at:

    * ``write_part`` failure: the parts barrier doubles as a write-outcome
      all-gather, so every rank (including rank 0, BEFORE it attempts a
      merge over a missing part) learns that some rank failed; all raise,
      successful ranks KEEP their parts.
    * ``merge`` failure on rank 0: the outcome is broadcast after the
      merge; EVERY rank raises and keeps its part file, so a transient
      rank-0 error (disk full, flaky storage) doesn't silently destroy the
      other ranks' sweep output: the merge can be retried from the parts.

    Multi-process only: single-process callers degrade before calling.
    """
    k, p = process_index(), process_count()
    part = f"{path}.{tag}-{k:05d}"
    t0 = time.perf_counter()
    write_err = None
    try:
        write_part(part)
    except BaseException as e:   # re-raised after the outcome gather
        write_err = e
    t_write = time.perf_counter()
    # the parts barrier doubles as the write-outcome gather: all ranks (and
    # rank 0 in particular, before it merges) agree on whether every part
    # was written, computed identically everywhere, so the early raise
    # below needs no further collective
    if p > 1:
        written = [None] * p
        dist.all_gather_object(written, write_err is None)
        all_written = all(written)
    else:
        all_written = write_err is None
    t_barrier = time.perf_counter()
    if not all_written:
        LOG.info("gather_parts[%s] rank %d/%d: part write FAILED on %s "
                 "rank (write %.2f s, outcome gather %.2f s)", tag, k, p,
                 "this" if write_err is not None else "another",
                 t_write - t0, t_barrier - t_write)
        if write_err is not None:
            raise write_err
        raise RuntimeError(
            f"part write failed on another rank for {path} — this rank's "
            f"part file {part} is kept so the sweep can be retried")
    result = None
    merge_err = None
    if k == 0:
        try:
            result = merge([f"{path}.{tag}-{i:05d}" for i in range(p)])
        except BaseException as e:   # re-raised after the barrier
            merge_err = e
    t_merge = time.perf_counter()
    # the post-merge synchronisation doubles as the outcome broadcast:
    # every rank learns whether rank 0's merge succeeded, and the broadcast
    # is the barrier that keeps ranks from deleting parts mid-merge
    if p > 1:
        box = [merge_err is None]
        dist.broadcast_object_list(box, src=0)
        ok = bool(box[0])
    else:
        ok = merge_err is None
    # read these to attribute a slow sharded write: a big barrier wait is a
    # straggler (rebalance predict_partition's weights), a big merge is
    # storage bandwidth on rank 0
    LOG.info("gather_parts[%s] rank %d/%d: part write %.2f s, barrier "
             "wait %.2f s, merge %.2f s", tag, k, p, t_write - t0,
             t_barrier - t_write, t_merge - t_barrier if k == 0 else 0.0)
    if merge_err is not None:
        raise merge_err          # rank 0: the original error, part kept
    if not ok:
        raise RuntimeError(
            f"sharded merge failed on rank 0 for {path} — this rank's "
            f"part file {part} is kept so the merge can be retried")
    os.remove(part)   # each process owns (wrote) exactly this file
    return result
