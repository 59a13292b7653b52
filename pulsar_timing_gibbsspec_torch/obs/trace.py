"""Structured pipeline trace spans (stdlib-only, zero-cost when off).

The port's copy of ``pulsar_timing_gibbsspec_tpu/obs/trace.py``: a
process-wide recorder of nested spans with monotonic timestamps, wired
into the driver's seams (``TorchGibbsDriver.run``: ``warmup.chunk``,
``chunk.host_prep``, ``chunk.dispatch``, ``chunk.carry_sync``,
``chunk.d2h``, ``chunk.writeback``, the ``drain.abandon_chunk``
instant) and the ``watchdog.<stage>`` instants of
:class:`..runtime.watchdog.DispatchWatchdog`.  Disabled, every call is
a shared ``nullcontext`` / early return: the hot loop pays one
attribute load per span, no allocation, no lock.

Enabled, finished spans/instants land in a bounded in-memory ring
buffer (oldest events drop first; :func:`dropped` counts the loss)
that exports to Perfetto/Chrome trace-event JSON (:func:`to_chrome`,
:func:`write_chrome`), and optionally stream to a ``sink`` callable
(:func:`jsonl_sink` appends ``metrics.jsonl`` lines in the
supervisor's record shape).

Separate from the buffer, *observers* (:func:`add_observer`) receive
every finished event live without buffering; an installed observer
activates the span seams even while the buffer is disabled.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time

_lock = threading.Lock()
_enabled = False
#: cap so a forgotten enable() cannot grow without bound (~100 bytes/ev)
MAX_EVENTS = 200_000
_events: collections.deque = collections.deque(maxlen=MAX_EVENTS)
_dropped = 0
_t0 = 0.0
_sink = None
_observers: list = []
_tids: dict = {}
_NULL = contextlib.nullcontext()


def enable(sink=None) -> None:
    """Start recording (clears the buffer).  ``sink``, if given, is
    called with a dict per finished span/instant — exceptions from it
    are swallowed (observability must not kill the run)."""
    global _enabled, _t0, _sink, _events, _dropped
    with _lock:
        # recreate so a monkeypatched MAX_EVENTS takes effect per-enable
        _events = collections.deque(maxlen=MAX_EVENTS)
        _dropped = 0
        _tids.clear()
        _t0 = time.monotonic()
        _sink = sink
        _enabled = True


def disable() -> None:
    """Stop recording.  The buffer is kept for late export; the sink,
    if it exposes ``flush``/``close`` (``jsonl_sink`` does), is flushed
    and closed.  Observers are managed independently and stay put."""
    global _enabled, _sink
    with _lock:
        _enabled = False
        sink, _sink = _sink, None
    for meth in ("flush", "close"):
        fn = getattr(sink, meth, None)
        if fn is not None:
            try:
                fn()
            except Exception:
                pass


def is_enabled() -> bool:
    return _enabled


def add_observer(fn) -> None:
    """Register a live event observer (called with each finished
    span/instant dict, outside the buffer lock; exceptions swallowed).
    Observers keep the span seams active even when buffering is off."""
    global _t0
    with _lock:
        if not _enabled and not _observers:
            _t0 = time.monotonic()   # give observer-only events a base
        if fn not in _observers:
            _observers.append(fn)


def remove_observer(fn) -> None:
    with _lock:
        if fn in _observers:
            _observers.remove(fn)


def dropped() -> int:
    """Events lost to the ring-buffer cap since the last ``enable()``."""
    return _dropped


def _tid() -> int:
    # spans finish on the watchdog worker thread as well as the main
    # thread (the dispatch closure runs inside DispatchWatchdog.call),
    # so the id registry needs the same lock as the ring buffer
    ident = threading.get_ident()
    with _lock:
        t = _tids.get(ident)
        if t is None:
            t = _tids[ident] = len(_tids) + 1
    return t


def _emit(ev: dict) -> None:
    global _dropped
    sink = _sink
    with _lock:
        if _enabled:
            if len(_events) == _events.maxlen:
                _dropped += 1           # deque evicts the oldest event
            _events.append(ev)
        observers = list(_observers) if _observers else None
    if sink is not None:
        try:
            sink(ev)
        except Exception:
            pass
    if observers:
        for fn in observers:
            try:
                fn(ev)
            except Exception:
                pass


class _Span:
    __slots__ = ("name", "args", "_start")

    def __init__(self, name, args):
        self.name = name
        self.args = args

    def __enter__(self):
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc):
        if not (_enabled or _observers):    # disabled mid-span: drop it
            return False
        end = time.monotonic()
        _emit({"ph": "X", "name": self.name,
               "ts": (self._start - _t0) * 1e6,
               "dur": (end - self._start) * 1e6,
               "pid": os.getpid(), "tid": _tid(),
               "args": self.args})
        return False


def span(name: str, **args):
    """Context manager timing a pipeline stage.  Nesting is expressed
    by containment of the ``ts``/``dur`` intervals (Chrome 'X' complete
    events), so concurrently open spans on one thread render stacked."""
    if not (_enabled or _observers):
        return _NULL
    return _Span(name, args)


def instant(name: str, **args) -> None:
    """A zero-duration marker (watchdog soft/stall events etc.)."""
    if not (_enabled or _observers):
        return
    _emit({"ph": "i", "name": name, "ts": (time.monotonic() - _t0) * 1e6,
           "pid": os.getpid(), "tid": _tid(), "s": "t", "args": args})


def events() -> list:
    with _lock:
        return list(_events)

def to_chrome() -> dict:
    """The Chrome/Perfetto trace-event JSON object.  When the ring
    buffer overflowed, a leading instant records how many events the
    timeline is missing."""
    evs = events()
    if _dropped:
        evs.insert(0, {"ph": "i", "name": "trace.ring_dropped",
                       "ts": 0.0, "pid": os.getpid(), "tid": 0, "s": "g",
                       "args": {"dropped": _dropped,
                                "cap": MAX_EVENTS}})
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def write_chrome(path) -> str:
    path = os.fspath(path)
    with open(path, "w") as fh:
        json.dump(to_chrome(), fh)
    return path


def jsonl_sink(path):
    """A ``sink`` that appends one metrics.jsonl line per event, in the
    supervisor's record shape (``runtime.supervisor._log_event``).
    Keeps one file handle open (line-buffered); ``disable()`` calls the
    attached ``flush``/``close``."""
    path = os.fspath(path)
    fh = open(path, "a", buffering=1)

    def _sink(ev):
        rec = {"ts": round(time.time(), 3), "event": "trace_span"
               if ev.get("ph") == "X" else "trace_instant",
               "name": ev["name"], **ev.get("args", {})}
        if ev.get("ph") == "X":
            rec["ms"] = round(ev["dur"] / 1e3, 3)
        fh.write(json.dumps(rec) + "\n")

    _sink.flush = fh.flush
    _sink.close = fh.close
    return _sink
