"""The ``--trace 1`` window: ``torch.profiler`` over the device and the
host, read back from its Chrome trace.

:class:`Traced` runs a window under the profiler and parses what it saw:
every device operation (kernels, copies, sets) with its start, length and
launch grid, and the benchmark's own host spans (``span``), which name what
the host was doing during each idle gap of the device.  A reader of a
per-layer metric takes what it needs from :class:`Trace`.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
SPAN_PREFIX = "pb."


def span(name: str):
    """A host span of the benchmark's own (a ``record_function`` range,
    seen only while the profiler runs)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Trace:
    """What one traced window saw.

    ``ops``: device operations ``(name, start_us, dur_us, grid, cat)``
    sorted by start; ``spans``: host spans ``(name, start_us, dur_us)``;
    ``window_s``: the window's length by the host clock."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.ops = sorted(
            ((e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
              tuple((e.get("args") or {}).get("grid") or ()), e["cat"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") in DEVICE_CATS), key=lambda o: o[1])
        self.spans = sorted(
            ((e["name"][len(SPAN_PREFIX):], float(e["ts"]),
              float(e.get("dur", 0.0)))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)),
            key=lambda s: s[1])

    def kernels(self, pattern: str | None = None) -> list:
        """Kernel launches, those whose name matches ``pattern`` if given."""
        rx = re.compile(pattern) if pattern else None
        return [o for o in self.ops if o[4] == "kernel"
                and (rx is None or rx.search(o[0]))]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, in us."""
        out: list[list[float]] = []
        for _, ts, dur, _, _ in self.ops:
            if out and ts <= out[-1][1]:
                out[-1][1] = max(out[-1][1], ts + dur)
            else:
                out.append([ts, ts + dur])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_share(self) -> float:
        """Share of the window with no device operation running, in %."""
        return max(0.0, 1.0 - self.busy_s() / self.window_s) * 100.0

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most."""
        tot: dict[str, float] = {}
        for name, _, dur, _, _ in self.ops:
            tot[name] = tot.get(name, 0.0) + dur * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[what the host was doing, seconds]]: the device's idle time
        inside the window, each gap named by the innermost benchmark span
        open at its start ("outside any span" where none was)."""
        busy = self.busy_intervals()
        if not busy:
            return []
        tot: dict[str, float] = {}
        opened: list = []                 # spans begun, in start order
        k = 0
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            while k < len(self.spans) and self.spans[k][1] <= end:
                opened.append(self.spans[k])
                k += 1
            opened = [s for s in opened if s[1] + s[2] > end]
            # the latest start among the open spans is the innermost
            name = opened[-1][0] if opened else "outside any span"
            tot[name] = tot.get(name, 0.0) + (nxt - end) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]


class Traced:
    """``with Traced(device) as t: <window>``; then ``t.trace``."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.trace: Trace | None = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json", prefix="pb-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            with contextlib.suppress(OSError):
                os.unlink(path)
        self.trace = Trace(events, window)
        return False
