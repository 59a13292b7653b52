"""Preemption-safe drain: SIGTERM/SIGINT -> deadline-bounded checkpoint.

The port's copy of ``pulsar_timing_gibbsspec_tpu/runtime/preemption.py``.
Shared cards end long runs with a SIGTERM (or a maintenance notice) and a
bounded grace window; this module turns that window into a clean exit:

1. :func:`install` registers signal handlers that call
   :func:`request_drain`, which is also the hook a maintenance watcher
   calls: it sets a process-wide drain flag with a deadline.
2. The driver's chunk loop stops queueing chunks once the flag is up and
   writes back or drops the chunk in flight by the time left
   (:func:`should_abandon`).
3. The facade's loop breaks, its flush persists every checked row, the
   checkpoint is verified (rolled back to ``.bak`` if it was torn) and
   :class:`Preempted` is raised.
4. ``run_supervised`` reports it as the ``preempted`` status: a
   resumable outcome, never retried in the process.

Streams are pure in the iteration, so the drained checkpoint resumes
bitwise in the next incarnation.  The state is process-wide and on the
monotonic clock; :func:`reset` clears it.
"""

from __future__ import annotations

import signal
import threading
import time

from . import telemetry

#: exit code of a drained (resumable) run: EX_TEMPFAIL, which batch
#: schedulers requeue on
EXIT_PREEMPTED = 75

#: grace window (seconds) when the requester names none
DEFAULT_DEADLINE_S = 30.0


class Preempted(RuntimeError):
    """The run drained to a checkpoint after a preemption request: a
    resumable outcome, not a failure.  ``rows`` is the recorded-row count
    persisted, ``verified`` whether the final set passed verification
    (after a rollback, when ``rolled_back``)."""

    def __init__(self, msg, rows=0, verified=True, rolled_back=False):
        super().__init__(msg)
        self.rows = int(rows)
        self.verified = bool(verified)
        self.rolled_back = bool(rolled_back)


# an RLock: request_drain runs in a signal handler on the main thread,
# which can interrupt that thread inside one of this module's locks
_lock = threading.RLock()
_event = threading.Event()
_state = {"reason": None, "requested_at": None, "deadline_s": None}
_prev_handlers: dict[int, object] = {}


def request_drain(reason="maintenance", deadline_s=None) -> None:
    """Ask every sampler in this process to drain.  Idempotent: the first
    request wins, a later one cannot extend the deadline."""
    with _lock:
        if _event.is_set():
            return
        _state["reason"] = str(reason)
        _state["requested_at"] = time.monotonic()
        _state["deadline_s"] = (DEFAULT_DEADLINE_S if deadline_s is None
                                else float(deadline_s))
        _event.set()
    telemetry.incr("preempt_requests")


def drain_requested() -> bool:
    """Cheap flag check for hot loops (no lock)."""
    return _event.is_set()


def deadline_remaining() -> float:
    """Seconds left in the grace window (+inf without a request; negative
    once the window is blown)."""
    with _lock:
        if not _event.is_set():
            return float("inf")
        return (_state["requested_at"] + _state["deadline_s"]
                - time.monotonic())


def should_abandon(est_s=0.0) -> bool:
    """True when ``est_s`` more seconds of work would blow the drain
    deadline: the chunk in flight is then dropped (its sweeps replay
    bitwise on resume)."""
    return _event.is_set() and deadline_remaining() < float(est_s)


def drain_info() -> dict:
    """Reason, age and time left of the request, for logs."""
    with _lock:
        if not _event.is_set():
            return {"requested": False}
        now = time.monotonic()
        return {"requested": True, "reason": _state["reason"],
                "age_s": round(now - _state["requested_at"], 3),
                "deadline_s": _state["deadline_s"],
                "remaining_s": round(_state["requested_at"]
                                     + _state["deadline_s"] - now, 3)}


def mark_drained() -> float:
    """Record a completed drain: the ``drain_latency_ms`` gauge and the
    ``preempt_drains`` counter.  Returns the latency in seconds (0.0
    without a pending request)."""
    with _lock:
        t0 = _state["requested_at"]
    lat = 0.0 if t0 is None else time.monotonic() - t0
    telemetry.gauge("drain_latency_ms", lat * 1000.0)
    telemetry.incr("preempt_drains")
    return lat


def install(signals=(signal.SIGTERM, signal.SIGINT),
            deadline_s=DEFAULT_DEADLINE_S) -> None:
    """Register drain-on-signal handlers (from the main thread).  A second
    signal during a drain restores the previous handler and raises
    ``KeyboardInterrupt``, so a double Ctrl-C still ends a wedged drain."""
    def _handler(signum, frame):
        if _event.is_set():
            prev = _prev_handlers.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            raise KeyboardInterrupt(f"second signal {signum} during drain")
        request_drain(reason=signal.Signals(signum).name,
                      deadline_s=deadline_s)

    for s in signals:
        _prev_handlers[s] = signal.getsignal(s)
        signal.signal(s, _handler)


def reset() -> None:
    """Clear the drain flag and deadline (between incarnations in one
    process)."""
    with _lock:
        _event.clear()
        _state.update(reason=None, requested_at=None, deadline_s=None)
