"""Framework bring-up (counterpart of ``icl/runtime/__init__.py``).

``init()`` is the single entry the CLIs call before any device work: the
multi-process bootstrap over ``torch.distributed`` (no-op single-process),
the device of this rank, the backend of the gradient sums, and the mesh.
Rng seeding is deliberately IDENTICAL on every rank (the loop seeds its
schedules from (seed, epoch) with no rank folded in): input sharding needs
every rank to agree on the global batch schedule and cut its own rows from
it (:func:`icl_torch.dist.mesh.local_data_rows`), and replicated parameters
need every rank to draw the same initial weights.

Two process groups.  The control plane (barriers, outcome exchanges,
objects) is the default group: gloo, on CPU tensors, always.  Gradient and
eval sums go through NCCL when the device is CUDA and no two ranks share a
GPU (learnt here, from an all-gather of host name and device count), else
through gloo on the same flat buffer.  Which one runs is logged once and
kept in ``Runtime.backend``; there is no flag for it and nothing is retried:
if NCCL is chosen and fails, the run fails.

``ICL_TORCH_DIST_TIMEOUT`` (seconds, default 1800) bounds every collective,
so a lost peer raises instead of hanging.  ``ICL_TORCH_RUN_STATS=<path>``
makes every rank write ``<path>.rank<k>.json`` when it exits: its kernel
launch counts, the all-reduce account and the backend.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import json
import os
import socket

import torch
import torch.distributed as dist

from icl_torch.dist import mesh as _mesh
from icl_torch.dist.mesh import Mesh, build_mesh
from icl_torch.util.log import LOG

DEFAULT_TIMEOUT_S = 1800.0


@dataclasses.dataclass
class Runtime:
    mesh: Mesh
    seed: int
    device: torch.device
    backend: str | None = None      # of the gradient sums; None: one process

    @property
    def num_devices(self) -> int:
        return self.mesh.data * self.mesh.model


# what this process bootstrapped with: torch.distributed does not keep the
# address, and an idempotent re-entry must reject a different one (the same
# rank and world against ANOTHER cluster would silently reuse the old
# group); the device and backend are kept for the re-entry to hand back
_boot: dict = {}


def _resolve(device: str | torch.device) -> torch.device:
    """``--device`` as a torch device; raises when the GPU is asked for and
    there is none.  No rank falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {device}: no CUDA device; the CLIs run on the GPU "
            f"unless the CPU is asked for (--device cpu)")
    return device


def _place_ranks(device: torch.device) -> tuple[torch.device, str]:
    """This rank's device and the backend of the sums, from one all-gather
    of (host, device type, device count): every rank computes the same
    table.  ``cuda`` means ``cuda:<local rank % device count>``, the local
    rank being the rank's index among the ranks of its host."""
    rank, world = dist.get_rank(), dist.get_world_size()
    mine = (socket.gethostname(), device.type,
            torch.cuda.device_count() if device.type == "cuda" else 0,
            device.index)
    table = [None] * world
    dist.all_gather_object(table, mine)
    placed = []
    for r, (host, kind, count, index) in enumerate(table):
        local = sum(1 for h, *_ in table[:r] if h == host)
        placed.append((host, kind, None if kind != "cuda" else
                       (local % count if index is None else index)))
    host, kind, index = placed[rank]
    if kind == "cuda":
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)     # before the first kernel
    else:
        # CPU ranks of one host share its cores: each takes its share, or
        # the ranks' thread pools spin against each other
        mates = sum(1 for h, *_ in table if h == host)
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // mates)))
    own_gpu = (all(k == "cuda" for _, k, _ in placed)
               and len(set(placed)) == world)
    return device, ("nccl" if own_gpu else "gloo")


def _write_run_stats(path: str) -> None:
    from icl_torch.ops.affinity_rank import affinity_rank
    from icl_torch.ops.grid_head import grid_head
    from icl_torch.ops import grid_head_train as ght
    from icl_torch.ops.lstm_recurrence import lstm_recurrence

    wrappers = {"grid_head": grid_head, "lstm_recurrence": lstm_recurrence,
                "lstm_recurrence_bwd": lstm_recurrence.bwd,
                "grid_head_train_fwd": ght.grid_head_train_fwd,
                "grid_head_train_bwd": ght.grid_head_train_bwd,
                "grid_head_train_loss_fwd": ght.grid_head_train_loss_fwd,
                "grid_head_train_loss_bwd": ght.grid_head_train_loss_bwd,
                "affinity_rank": affinity_rank,
                # the bf16 modes
                "grid_head_bf16dot": grid_head.bf16dot,
                "lstm_recurrence_bf16": lstm_recurrence.bf16,
                "lstm_recurrence_bwd_bf16": lstm_recurrence.bwd_bf16,
                "affinity_rank_bf16dot": affinity_rank.bf16dot,
                # the one-pass bf16 mode of the training kernels
                "grid_head_train_fwd_onepass": ght.grid_head_train_fwd.onepass,
                "grid_head_train_bwd_onepass": ght.grid_head_train_bwd.onepass,
                "grid_head_train_loss_fwd_onepass":
                    ght.grid_head_train_loss_fwd.onepass,
                "grid_head_train_loss_bwd_onepass":
                    ght.grid_head_train_loss_bwd.onepass}
    rank = _boot.get("process_id", 0)
    with open(f"{path}.rank{rank}.json", "w") as f:
        json.dump({"rank": rank, "world": _boot.get("num_processes", 1),
                   "backend": _boot.get("backend"),
                   "device": str(_boot.get("device")),
                   "launches": {k: fn.launches for k, fn in wrappers.items()},
                   "all_reduce": dict(_mesh.REDUCE_STATS)}, f)


def init(topology: str | None = None, seed: int = 0,
         coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None,
         device: str | torch.device = "cuda") -> Runtime:
    """Bring up the runtime: distributed bootstrap (if multi-process), this
    rank's device, the mesh.

    The multi-process branch is gated on ``process_id``: each launcher
    passes its own id, so a config that carries ``hosts: {coordinator,
    num_processes}`` can still be run single-process (scaled down) by simply
    not passing ``--process_id``.
    """
    device = _resolve(device)
    backend = None
    if process_id is not None:
        if coordinator is None or num_processes is None:
            raise ValueError("--process_id requires --coordinator and "
                             "--num_processes (directly or via --config)")
        if dist.is_initialized():
            # idempotent re-entry: icl-torch-joint runs several task mains
            # inside ONE process, so the 2nd+ init must reuse the bootstrap,
            # but only if it describes the SAME topology this process joined
            if (dist.get_world_size() != num_processes
                    or dist.get_rank() != process_id
                    or coordinator != _boot.get("coordinator")):
                raise ValueError(
                    f"distributed already initialized as process "
                    f"{dist.get_rank()}/{dist.get_world_size()} via "
                    f"{_boot.get('coordinator')} — conflicting --process_id "
                    f"{process_id}/--num_processes {num_processes}/"
                    f"--coordinator {coordinator}")
            if device.type != _boot["device"].type:
                raise ValueError(
                    f"distributed already initialized on "
                    f"{_boot['device']} — conflicting --device {device}")
            device, backend = _boot["device"], _boot["backend"]
            LOG.info("distributed: reusing bootstrap (process %d/%d)",
                     dist.get_rank(), dist.get_world_size())
        else:
            timeout = float(os.environ.get("ICL_TORCH_DIST_TIMEOUT",
                                           DEFAULT_TIMEOUT_S))
            dist.init_process_group(
                backend="gloo", init_method=f"tcp://{coordinator}",
                rank=process_id, world_size=num_processes,
                timeout=datetime.timedelta(seconds=timeout))
            device, backend = _place_ranks(device)
            group = None
            if backend == "nccl":
                group = dist.new_group(
                    backend="nccl",
                    timeout=datetime.timedelta(seconds=timeout))
            _mesh.set_reduce_group(group, backend)
            _boot.update(coordinator=coordinator, device=device,
                         backend=backend, process_id=process_id,
                         num_processes=num_processes)
            atexit.register(shutdown)
            LOG.info("distributed: process %d/%d via %s on %s; gradient and "
                     "eval sums over %s, control plane over gloo (timeout "
                     "%.0f s)", process_id, num_processes, coordinator,
                     device, backend, timeout)
    elif coordinator is not None:
        LOG.warning("coordinator %s configured but no --process_id given: "
                    "running single-process (scaled-down mode)", coordinator)
    stats = os.environ.get("ICL_TORCH_RUN_STATS")
    if stats and not _boot.get("stats"):
        _boot.setdefault("device", device)
        _boot["stats"] = stats
        atexit.register(_write_run_stats, stats)
    try:
        mesh = build_mesh(topology)
    except ValueError:
        if not (process_id is None and coordinator is not None):
            raise
        # scaled-down mode: a multi-process config's mesh (e.g. 256x1)
        # exceeds this one process: fall back to the one-rank mesh
        LOG.warning("configured mesh %r needs more devices than the %d "
                    "available; scaled-down mode falls back to local DP",
                    topology, _mesh.process_count())
        mesh = build_mesh(None)
    world = _mesh.process_count()
    if world > 1 and mesh.data * mesh.model != world:
        # every rank must sit in the mesh: a rank outside it would feed no
        # rows and still be waited for at the first collective.  Computed
        # identically on every rank, so ALL ranks raise the same error and
        # exit cleanly instead of hanging until the timeout.
        missing = list(range(mesh.data * mesh.model, world))
        raise ValueError(
            f"--mesh {topology!r} covers {mesh.data * mesh.model} of "
            f"{world} global devices, leaving process(es) {missing} with "
            f"no mesh devices — size the mesh to every process (e.g. "
            f"--mesh {world // mesh.model}x{mesh.model}); a smaller mesh "
            f"strands those ranks at the first collective")
    LOG.info("runtime: %d device(s) [%s], mesh %s", mesh.data * mesh.model,
             "gpu" if device.type == "cuda" else device.type,
             dict(mesh.shape))
    return Runtime(mesh=mesh, seed=seed, device=device, backend=backend)


def shutdown() -> None:
    """Leave the process group (tests and tools that bring up more than one
    runtime in a process); a later :func:`init` bootstraps anew."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _mesh.set_reduce_group(None, None)
    for key in ("coordinator", "device", "backend", "process_id",
                "num_processes"):
        _boot.pop(key, None)
