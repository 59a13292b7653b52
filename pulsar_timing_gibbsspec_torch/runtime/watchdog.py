"""Dispatch watchdog: an EMA deadline around the driver's host waits.

The port's copy of ``pulsar_timing_gibbsspec_tpu/runtime/watchdog.py``.
A hung device (a wedged CUDA context, a lost card) looks like a very
slow chunk that never ends; the watchdog turns "never ends" into the
retryable ``stall`` failure class:

- The deadline is ``k`` times an EMA of steady waits, per sweep, floored
  at ``floor_s``; before any wait was measured, ``first_floor_s``.
- One guarded call escalates: past the soft deadline (``soft_frac`` of
  the hard one) it counts ``watchdog_soft``; at the hard deadline it
  dumps every thread's stack (``watchdog_dumps``), abandons the call and
  raises :class:`DispatchStall` (``watchdog_stalls``).
- ``fn`` runs on a reusable worker thread so that the waiter can time
  out; an abandoned worker is detached and a fresh one serves the next
  call.

**What the port guards.**  The JAX package guards the dispatch itself:
its chunk is a pure function, so a late completion of an abandoned call
changes nothing.  The port's chunk is not pure (graph replays write
static buffers, the generator is re-seeded per sweep, the record buffers
are shared), and a worker that woke after being given up on must not
queue work on the card while the retry runs.  So the driver queues every
chunk on its own thread and guards only the host side: ``fn`` is the
``dispatch.chunk`` fault seam (pure host code), and ``done`` (a poll of
the previous chunk's copy event, on the calling thread) is the wait for
the card.  An abandoned worker then has nothing left to do on the
device, and no thread but the driver's touches CUDA.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback

from ..obs import trace as otrace
from . import telemetry


#: seconds between two polls of a guarded call's ``done``
DONE_POLL_S = 0.001


class DispatchStall(RuntimeError):
    """A guarded call blew its hard deadline and was abandoned."""


def dump_stacks() -> str:
    """Formatted stacks of every live thread (the hang post-mortem)."""
    out = []
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(tid, '?')} ({tid}) ---")
        out.extend(ln.rstrip() for ln in traceback.format_stack(frame))
    return "\n".join(out)


class DispatchWatchdog:
    """Heartbeat guard of the driver's host waits.

    ``observe(dt, n)`` feeds steady wall times; ``call(fn, ..., done=)``
    runs ``fn`` and then polls ``done`` under the current deadline.
    ``on_event`` (optional) receives ``(stage, info)`` for ``"soft" |
    "dump" | "stall"``."""

    def __init__(self, k=4.0, floor_s=30.0, first_floor_s=1800.0,
                 ema_alpha=0.3, soft_frac=0.5, on_event=None,
                 poll_s=0.05):
        if k <= 1.0:
            raise ValueError("watchdog k must exceed 1 (deadline must "
                             "sit above the steady chunk wall)")
        self.k = float(k)
        self.floor_s = float(floor_s)
        self.first_floor_s = float(first_floor_s)
        self.ema_alpha = float(ema_alpha)
        self.soft_frac = float(soft_frac)
        self.on_event = on_event
        self.poll_s = float(poll_s)
        self.ema = None
        self._n_seen = None
        self._worker = None
        self._inbox = None

    # -- deadline model ------------------------------------------------------

    def _check_geometry(self, n) -> None:
        """Reset the EMA when the sweeps per guarded call change: the
        per-sweep wall is not invariant under it, and the first call after
        the change falls back to ``first_floor_s``."""
        n = max(int(n), 1)
        if self._n_seen is not None and n != self._n_seen \
                and self.ema is not None:
            self.ema = None
            telemetry.incr("watchdog_ema_resets")
        self._n_seen = n

    def observe(self, dt, n=1) -> None:
        """Feed one steady wall time (seconds) covering ``n`` sweeps; the
        EMA is kept per sweep."""
        self._check_geometry(n)
        per = float(dt) / max(int(n), 1)
        self.ema = per if self.ema is None else (
            self.ema_alpha * per + (1.0 - self.ema_alpha) * self.ema)
        telemetry.gauge("watchdog_ema_s", self.ema)
        telemetry.gauge("watchdog_deadline_s", self.deadline(n))

    def deadline(self, n=1) -> float:
        """The hard deadline (seconds) of one guarded call of ``n``
        sweeps."""
        if self.ema is None:
            return self.first_floor_s
        return max(self.floor_s, self.k * self.ema * max(int(n), 1))

    # -- guarded execution ---------------------------------------------------

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._inbox = {"fn": None, "go": threading.Event(),
                           "done": threading.Event(), "out": None,
                           "exc": None}
            self._worker = threading.Thread(
                target=self._serve, args=(self._inbox,),
                name="dispatch-watchdog-worker", daemon=True)
            self._worker.start()

    @staticmethod
    def _serve(box):
        while True:
            box["go"].wait()
            box["go"].clear()
            fn = box["fn"]
            if fn is None:
                return
            try:
                box["out"] = fn()
            except BaseException as exc:    # noqa: BLE001 (re-raised)
                box["exc"] = exc
            box["done"].set()

    def _emit(self, stage, info):
        # the trace keeps the escalation timeline (``watchdog.<stage>``
        # instants), not the stack dumps; those go through on_event
        otrace.instant(f"watchdog.{stage}",
                       **{k: v for k, v in info.items() if k != "stacks"})
        if self.on_event is not None:
            try:
                self.on_event(stage, info)
            except Exception:
                pass              # observability must not end the run

    def call(self, fn, what="dispatch", n=1, done=None):
        """Run ``fn()`` on the worker, then poll ``done()`` (when given) on
        this thread, both under the deadline for ``n`` sweeps; returns
        ``fn``'s result or re-raises its exception.  Raises
        :class:`DispatchStall` when the hard deadline passes."""
        self._check_geometry(n)
        self._ensure_worker()
        box = self._inbox
        box["fn"], box["out"], box["exc"] = fn, None, None
        box["done"].clear()
        box["go"].set()
        hard = self.deadline(n)
        soft = self.soft_frac * hard
        t0 = time.monotonic()
        warned = [False]

        def tick():
            el = time.monotonic() - t0
            if not warned[0] and el >= soft:
                warned[0] = True
                telemetry.incr("watchdog_soft")
                self._emit("soft", {"what": what, "elapsed_s": el,
                                    "deadline_s": hard})
            if el >= hard:
                telemetry.incr("watchdog_dumps")
                self._emit("dump", {"what": what, "elapsed_s": el,
                                    "stacks": dump_stacks()})
                # the worker may still be blocked: drop it, and let the
                # next call start a clean one
                self._worker = None
                self._inbox = None
                telemetry.incr("watchdog_stalls")
                self._emit("stall", {"what": what, "elapsed_s": el,
                                     "deadline_s": hard})
                raise DispatchStall(
                    f"{what} exceeded the watchdog deadline "
                    f"({el:.1f}s > {hard:.1f}s; steady EMA "
                    f"{'unset' if self.ema is None else f'{self.ema:.2f}s'}"
                    " per sweep) — abandoned; resume from the last "
                    "committed checkpoint")

        while not box["done"].wait(self.poll_s):
            tick()
        if box["exc"] is not None:
            raise box["exc"]
        if done is not None:
            while not done():
                tick()
                time.sleep(DONE_POLL_S)
        return box["out"]
