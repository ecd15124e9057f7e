"""LogUtil — leveled logging with elapsed-time ticks (component C11).

Reference parity: SURVEY.md §3.1 C11 — the reference's ``utils/Logger.py``
exposed leveled console logging plus tic/toc progress ticks ("% complete
every N seconds").  Rebuilt on stdlib logging (absl-compatible stream) with
the same surface: ``info/debug/warning/error`` plus ``tic``/``toc``.

The port's own copy of ``icl/util/log.py``: ``icl_torch`` imports
nothing of the JAX package, and ``tests/test_torch_data.py`` holds the two
copies to the same outputs.  Rationale below is the original's; where it
names XLA or the TPU, read PyTorch and the GPU.
"""

from __future__ import annotations

import logging
import sys
import time

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR}


class LogUtil:
    """Leveled logger with rate-limited progress ticks.

    ``tic(total)`` starts a progress context; ``toc(done)`` logs
    "<pct>% complete (<done>/<total>); <rate>/s; elapsed <s>s" at most once
    per ``tick_seconds``.
    """

    def __init__(self, level: str = "info", tick_seconds: float = 10.0,
                 name: str = "icl"):
        self._log = logging.getLogger(name)
        if not self._log.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "%(asctime)s [%(levelname)s] %(message)s", "%H:%M:%S"))
            self._log.addHandler(h)
        self._log.setLevel(_LEVELS.get(level, logging.INFO))
        self._log.propagate = False
        self.tick_seconds = tick_seconds
        self._tic_start = 0.0
        self._tic_total = 0
        self._last_tick = 0.0

    def debug(self, msg: str, *args) -> None: self._log.debug(msg, *args)
    def info(self, msg: str, *args) -> None: self._log.info(msg, *args)
    def warning(self, msg: str, *args) -> None: self._log.warning(msg, *args)
    def error(self, msg: str, *args) -> None: self._log.error(msg, *args)

    def tic(self, total: int, what: str = "items") -> None:
        self._tic_start = time.monotonic()
        self._tic_total = total
        self._what = what
        self._last_tick = 0.0

    def toc(self, done: int, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_tick < self.tick_seconds:
            return
        self._last_tick = now
        elapsed = max(now - self._tic_start, 1e-9)
        pct = 100.0 * done / self._tic_total if self._tic_total else 0.0
        self.info("%5.1f%% complete (%d/%d %s); %.1f/s; elapsed %.1fs",
                  pct, done, self._tic_total, getattr(self, "_what", "items"),
                  done / elapsed, elapsed)


LOG = LogUtil()
