"""The port's own spans and counters, kept only while a profile is taken.

A span is a named stretch of host time in the layer that does the work (a
batch's copy to the device, a phase of the train step); a counter adds up
a quantity of the work itself (staged box rows).  Both are kept only while
a ``torch.profiler`` session is running in the process: ``--profile_dir``
(:func:`icl_torch.train.loop.profile_trace`) and any other profile switch
them on, and nothing else does.  There is no flag of their own.

Off, :func:`span` costs one check of the profiler's flag and a thread-local
read, and returns a shared do-nothing context: no ``record_function`` is
entered (that costs some 14 us even with no profiler running) and no event
is made.  On, each span opens ``record_function("icl.<name>")``, so it lies
in the Chrome trace on the same clock as the device's kernels, and adds an
event to an in-memory log: its id, name, the id of its parent span (the
innermost one open on the same thread), the thread's native id, start and
end (``time.perf_counter_ns``) and attributes.  :func:`snapshot` returns
the per-name totals (count, seconds, self seconds: the duration less the
time its child spans cover), the counters, and the log, which holds at most
:data:`MAX_EVENTS` events and counts those it dropped; the totals count
every span.

The profiler's flag is thread-local: it reads True on the thread that
started the profile and inside an autograd backward, but False on a plain
``threading.Thread``, whose ``record_function`` ranges are also missing
from the Chrome trace.  A thread whose work is handed to another, as the
batch prefetch worker's is, runs it under :func:`hold`: the spans and
counters made there are timed and kept with the item, whatever the flag,
and :func:`take`, on the thread that receives the item, records them if a
profile is running there and drops them otherwise.  So they are kept for
exactly the items taken while a profile runs.

The kernel wrappers of :mod:`icl_torch.ops` count their launches through
:func:`launched`, in their own ``launches`` attributes, kept whether or not
a profile runs.  A CUDA graph's capture records work without running it:
the counts and launches made while :func:`tape` is open go to its list
instead, whatever the flag, and :func:`replay` makes them again at every
replay of the graph.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

PREFIX = "icl."
MAX_EVENTS = 100_000


class _Local(threading.local):
    held = None     # the _Held bundle this thread keeps its spans in
    stack = None    # this thread's open spans, innermost last
    tid = None      # the thread's native id (a system call to learn)


class _Held:
    """Spans (as events) and counts made on a thread under :func:`hold`."""

    __slots__ = ("events", "counts")

    def __init__(self):
        self.events: list = []
        self.counts: list = []


_tls = _Local()
_ids = itertools.count(1)
_lock = threading.Lock()
_log: dict = {"events": [], "dropped": 0, "spans": {}, "counters": {}}
_tape: list | None = None   # where counts go while :func:`tape` is open


def enabled() -> bool:
    """Whether a profile is running, as this thread sees it."""
    return bool(_profiler_enabled())


class _Off:
    """The span returned while nothing is kept: falsy, so a caller can
    skip computing attributes with ``if sp:``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "held", "id", "parent", "t0", "child_ns",
                 "_rf")

    def __init__(self, name: str, attrs: dict, held: _Held | None):
        self.name, self.attrs, self.held = PREFIX + name, attrs, held

    def set(self, **attrs) -> None:
        """Add attributes to the span's event."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _tls.stack
        if stack is None:
            stack = _tls.stack = []
            _tls.tid = threading.get_native_id()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.id = next(_ids)
        self.child_ns = 0
        if self.held is None:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.held is None:
            self._rf.__exit__(*exc)
        _tls.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += t1 - self.t0
        event = (self.id, self.name, parent.id if parent is not None else None,
                 _tls.tid, self.t0, t1, self.attrs, self.child_ns)
        if self.held is None:
            _record((event,), ())
        else:
            self.held.events.append(event)
        return False


def span(name: str, **attrs):
    """A context over a stretch of host time, kept as ``icl.<name>`` while
    a profile runs (module docstring); ``attrs`` go into its event, and
    ``.set(**attrs)`` adds more before it closes."""
    held = _tls.held
    if held is not None:
        return _Span(name, attrs, held)
    if not _profiler_enabled():
        return OFF
    return _Span(name, attrs, None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profile runs."""
    held = _tls.held
    if held is not None:
        held.counts.append((name, n))
    elif _tape is not None:
        _tape.append((name, n))
    elif _profiler_enabled():
        _record((), ((name, n),))


def launched(counter, n: int = 1, attr: str = "launches") -> None:
    """Add ``n`` to a kernel wrapper's count of its launches,
    ``counter.<attr>``; while :func:`tape` is open, to its list instead."""
    if _tape is not None:
        _tape.append(((counter, attr), n))
    else:
        setattr(counter, attr, getattr(counter, attr) + n)


@contextlib.contextmanager
def tape():
    """While open, the counts (:func:`count`) made on every thread not
    under :func:`hold` (autograd's device thread too) and the launches
    (:func:`launched`) go to the list it yields, not to the log or the
    wrappers, whether or not a profile runs: those of work recorded into a
    CUDA graph, which each replay makes again (:func:`replay`)."""
    global _tape
    _tape = counts = []
    try:
        yield counts
    finally:
        _tape = None


def replay(counts: list) -> None:
    """Make again the counts and launches a :func:`tape` took."""
    for key, n in counts:
        if isinstance(key, str):
            count(key, n)
        else:
            launched(key[0], n, key[1])


def hold(name: str, fn):
    """``fn()`` on a thread that hands its result to another, timed as span
    ``name``, with the spans and counts it makes kept aside: returns
    ``(fn(), held)``; give ``held`` to :func:`take` where the result is
    taken.  Exceptions of ``fn`` propagate and drop what was held."""
    held = _tls.held = _Held()
    try:
        with _Span(name, {}, held):
            out = fn()
    finally:
        _tls.held = None
    return out, held


def take(held: _Held) -> None:
    """Record what :func:`hold` kept if a profile runs on this thread;
    drop it otherwise."""
    if _profiler_enabled():
        _record(held.events, held.counts)


def _record(events, counts) -> None:
    with _lock:
        totals, log = _log["spans"], _log["events"]
        for ev in events:
            t = totals.get(ev[1])
            if t is None:
                t = totals[ev[1]] = [0, 0, 0]
            dur = ev[5] - ev[4]
            t[0] += 1
            t[1] += dur
            t[2] += dur - ev[7]
            if len(log) < MAX_EVENTS:
                log.append(ev)
            else:
                _log["dropped"] += 1
        for name, n in counts:
            _log["counters"][name] = _log["counters"].get(name, 0) + n


def _event(ev) -> dict:
    return {"id": ev[0], "name": ev[1], "parent": ev[2], "thread": ev[3],
            "start_ns": ev[4], "end_ns": ev[5], "attrs": ev[6]}


def snapshot() -> dict:
    """What was kept since the last :func:`reset`: ``spans`` (name ->
    count, seconds, self_seconds), ``counters``, ``events`` (dicts, in the
    order they were recorded) and ``dropped``."""
    with _lock:
        return {
            "spans": {k: {"count": c, "seconds": ns * 1e-9,
                          "self_seconds": own * 1e-9}
                      for k, (c, ns, own) in _log["spans"].items()},
            "counters": dict(_log["counters"]),
            "events": [_event(ev) for ev in _log["events"]],
            "dropped": _log["dropped"]}


def reset() -> None:
    """Forget every kept span, event and counter."""
    with _lock:
        _log.update(events=[], dropped=0, spans={}, counters={})


def write_jsonl(path: str) -> None:
    """The log as JSON lines: one event a line, then one line of the
    totals (``spans``, ``counters``, ``dropped``)."""
    snap = snapshot()
    with open(path, "w", encoding="utf-8") as f:
        for ev in snap.pop("events"):
            f.write(json.dumps(ev) + "\n")
        f.write(json.dumps(snap) + "\n")
