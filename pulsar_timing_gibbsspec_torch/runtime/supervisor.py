"""Supervised sampling: the retry loop and the failure classes.

The port's copy of ``pulsar_timing_gibbsspec_tpu/runtime/supervisor.py``
(``run_supervised``, ``classify_failure``, ``backoff_delay``,
``SupervisorReport``, and the serving tier's ``CircuitOpen``,
``CircuitBreaker`` and ``AdmissionController``).  ``run_supervised``
drives ``gibbs.sample(resume=True)`` to the end through transient
failures: each attempt resumes from the last verified checkpoint (the
facade's flush bounds the loss to under ``save_every`` sweeps), retries
are spaced by capped exponential backoff with deterministic jitter, and
each failure class gets its own response:

- ``device``      CUDA runtime errors, out of memory, the injected device
                  error: retry.  The JAX package degrades a one-chain run
                  to its NumPy oracle after ``degrade_after`` in a row;
                  the port does not: a run given to the card keeps
                  retrying on the card, never moving to the CPU, until
                  the budget ends (a sticky CUDA error, which poisons the
                  context, ends there too).  The port's oracle runs only
                  where the caller asks for it (``backend="numpy"``).
- ``device_loss`` a device left the run (:class:`.faults.DeviceLost`):
                  counted with ``device``, and retried; moving the run
                  onto the surviving devices is the caller's
                  (``integrity.reshard_restore``).
- ``corruption``  a checkpoint that failed verification past repair:
                  roll back to ``.bak``, then retry.
- ``divergence``  a NaN or stuck chain caught by the sentinels: rewind
                  (the bad rows never reached the checkpoint) and replay;
                  the same divergence again on the replay refolds the
                  checkpoint's seed.
- ``crash``       injected kills, OS errors: plain retry.
- ``stall``       a wait the watchdog abandoned: its own retry budget
                  (``stall_max_retries``) and backoff.
- ``preempted``   a drain after SIGTERM: not a failure; the report says
                  ``status="preempted"`` and the call returns.
- ``user``        bugs and contract violations (shape errors, "no CUDA
                  device is available"): raised at once.

Under a mesh (``gibbs.mesh``, :mod:`..parallel.sharding`) every rank
runs this loop on its own facade and sees the same exception at the same
seam (the facade broadcasts the writer's save outcome), so every rank
takes the same branch; only the writer (global rank 0) writes events,
rolls back or refolds a checkpoint, and the others learn its outcome.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path

import numpy as np

from . import faults, integrity, preemption, sentinels, telemetry
from .watchdog import DispatchStall

#: RuntimeError text of a fault in the caller's setup, not in the card:
#: a retry cannot fix it
_USER_MARKERS = ("no cuda device", "cuda is not available",
                 "torch not compiled with cuda", "found no nvidia driver",
                 "expected all tensors to be on the same device")
#: RuntimeError text of a device or runtime failure (the JAX package's
#: markers, then the CUDA stack's)
_DEVICE_MARKERS = ("xla", "device", "tpu", "out of memory",
                   "resource exhausted", "internal error", "cuda",
                   "cublas", "cusolver", "cudnn", "nccl",
                   "illegal memory access", "launch failure")
#: exception types that are device failures by name (torch's own, and
#: the JAX runtime's, which a mixed process may raise)
_DEVICE_TYPES = ("OutOfMemoryError", "AcceleratorError", "InternalError")


def classify_failure(exc) -> str:
    """Map an exception from ``sample()`` to a failure class: ``device |
    device_loss | corruption | divergence | crash | stall | preempted |
    user | unknown``."""
    if isinstance(exc, preemption.Preempted):
        return "preempted"
    if isinstance(exc, DispatchStall):
        return "stall"
    if isinstance(exc, faults.DeviceLost):
        # lost capacity does not come back on retry: the caller must
        # evacuate onto the surviving devices, not replay blindly
        return "device_loss"
    if isinstance(exc, faults.InjectedCrash):
        return "crash"
    if isinstance(exc, integrity.CheckpointError):
        return "corruption"
    if isinstance(exc, FloatingPointError):    # ChainDivergence too
        return "divergence"
    if isinstance(exc, faults.InjectedDeviceError):
        return "device"
    name = type(exc).__name__
    low = str(exc).lower()
    if "xlaruntimeerror" in name.lower() or name in _DEVICE_TYPES:
        return "device"
    if "transfer" in low and ("guard" in low or "disallow" in low):
        return "user"
    if isinstance(exc, (ValueError, TypeError, KeyError, IndexError,
                        AttributeError, NotImplementedError,
                        AssertionError)):
        return "user"
    if isinstance(exc, OSError):
        return "crash"
    if isinstance(exc, RuntimeError):
        if any(t in low for t in _USER_MARKERS):
            return "user"
        if any(t in low for t in _DEVICE_MARKERS):
            return "device"
        return "user"        # resume-contract violations et al.
    return "unknown"


def backoff_delay(retry, base=0.5, cap=30.0, jitter=0.25, seed=0) -> float:
    """Capped exponential backoff with deterministic jitter: ``retry`` is
    1-based, and the jitter is a pure function of ``(seed, retry)``."""
    d = min(float(cap), float(base) * (2.0 ** (retry - 1)))
    u = np.random.default_rng([int(seed), int(retry)]).uniform(-jitter,
                                                               jitter)
    return max(0.0, d * (1.0 + float(u)))


class CircuitOpen(RuntimeError):
    """A circuit breaker rejected the operation: the subject has been
    failing at a rate that makes immediate retry harmful.  Carries the
    breaker so callers can report the cooldown."""

    def __init__(self, msg, breaker=None):
        super().__init__(msg)
        self.breaker = breaker


class CircuitBreaker:
    """Failure-rate circuit breaker (closed → open → half-open).

    CLOSED counts outcomes over a sliding window of the last ``window``
    events; once at least ``min_events`` are in the window and the
    failure fraction reaches ``threshold`` the breaker OPENS — calls
    are rejected for ``cooldown_s``.  After the cooldown it goes
    HALF-OPEN: exactly one probe is allowed through; a recorded success
    closes the breaker (window cleared), a failure re-opens it with a
    fresh cooldown.  ``clock`` is injectable so tests (and the seeded
    chaos campaign) never sleep real time.

    The serving tier keys one breaker per tenant: a tenant whose
    uploads keep diverging stops being re-admitted at full cadence —
    its retries cost the service build/dispatch wall that healthy
    tenants are paying for.

    Thread-safe: every transition and query runs under one instance
    RLock.  Without it, two concurrent ``allow`` callers can both
    observe ``_probing`` False and BOTH claim the single half-open
    probe (check-then-set), so one failing probe re-opens the breaker
    while a duplicate probe is already in flight.
    """

    def __init__(self, window=8, threshold=0.5, min_events=2,
                 cooldown_s=30.0, clock=time.monotonic):
        self.window = int(window)
        self.threshold = float(threshold)
        self.min_events = max(1, int(min_events))
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._lock = threading.RLock()
        self._events: list[bool] = []     # True = failure
        self.state = "closed"
        self.opened_at = None
        self.opens = 0
        self._probing = False

    def _failure_rate(self) -> float:
        if not self._events:
            return 0.0
        return sum(self._events) / len(self._events)

    def record_failure(self) -> None:
        with self._lock:
            if self.state == "half_open":
                # the probe failed: straight back to open, fresh cooldown
                self._trip()
                return
            self._events = (self._events + [True])[-self.window:]
            if (self.state == "closed"
                    and len(self._events) >= self.min_events
                    and self._failure_rate() >= self.threshold):
                self._trip()

    def record_success(self) -> None:
        with self._lock:
            if self.state == "half_open":
                # probe succeeded: the fault cleared — close and forget
                self.state = "closed"
                self._events = []
                self._probing = False
                return
            self._events = (self._events + [False])[-self.window:]

    def _trip(self) -> None:
        with self._lock:
            self.state = "open"
            self.opened_at = self.clock()
            self.opens += 1
            self._probing = False
        telemetry.incr("circuit_opens")

    def would_allow(self) -> bool:
        """Non-consuming query: would :meth:`allow` pass right now?
        (Never transitions state or claims the half-open probe slot —
        submit-time gating must not eat the scheduler's probe.)"""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                return self.clock() - self.opened_at >= self.cooldown_s
            return not self._probing

    def allow(self) -> bool:
        """True when a call may proceed: always in CLOSED; in OPEN only
        once the cooldown elapsed (transitioning to HALF-OPEN); in
        HALF-OPEN only for the single in-flight probe.  The
        claim-the-probe decision is atomic under the instance lock:
        exactly one concurrent caller wins the half-open slot."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if self.clock() - self.opened_at >= self.cooldown_s:
                    self.state = "half_open"
                    self._probing = True
                    return True
                return False
            # half-open: one probe at a time
            if not self._probing:
                self._probing = True
                return True
            return False

    def check(self, subject="operation") -> None:
        """Raise :class:`CircuitOpen` unless :meth:`would_allow` —
        a query, not a claim: the probe slot stays available."""
        with self._lock:
            if self.would_allow():
                return
            wait = 0.0 if self.opened_at is None else max(
                0.0, self.cooldown_s - (self.clock() - self.opened_at))
            raise CircuitOpen(
                f"circuit open for {subject}: failure rate "
                f"{self._failure_rate():.2f} over the last "
                f"{len(self._events)} attempt(s) — retry in "
                f"{wait:.1f}s", breaker=self)

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state, "opens": int(self.opens),
                    "failure_rate": round(self._failure_rate(), 3),
                    "events": len(self._events)}


class AdmissionController:
    """Service-level admission control / backpressure, driven by the
    gauges the serving tier already publishes:

    - ``queue_depth`` — past ``max_queue`` the service REJECTS new
      submissions (typed :class:`CircuitOpen`): unbounded queues turn
      overload into latency for everyone instead of an error for the
      marginal request.
    - ``compile_stalls`` — ``note_compile()`` timestamps every cold
      compile; when ``storm_compiles`` of them land within
      ``storm_window_s`` the controller declares a COMPILE STORM and
      ``defer_cold()`` tells the scheduler to hold NEW dataset shapes
      (cold buckets) in the queue while warm jobs keep the device busy
      — a burst of novel shapes would otherwise serialize everyone
      behind back-to-back model builds and graph captures
      (``time_to_first_sample_ms`` blows up service-wide).

    Deferral is never starvation: once the storm window drains (no new
    cold compile for ``storm_window_s``), cold jobs admit again.
    """

    def __init__(self, max_queue=64, storm_compiles=3, storm_window_s=60.0,
                 clock=time.monotonic):
        self.max_queue = int(max_queue)
        self.storm_compiles = int(storm_compiles)
        self.storm_window_s = float(storm_window_s)
        self.clock = clock
        self._compiles: list[float] = []
        self.rejections = 0
        self.deferrals = 0

    def admit_submission(self, queue_depth) -> None:
        """Gate one submission on backpressure; raises
        :class:`CircuitOpen` when the queue is full."""
        if int(queue_depth) >= self.max_queue:
            self.rejections += 1
            telemetry.incr("admission_rejections")
            raise CircuitOpen(
                f"admission rejected: queue depth {int(queue_depth)} "
                f">= {self.max_queue} (backpressure — resubmit after "
                "the queue drains)", breaker=None)

    def note_compile(self) -> None:
        """Record one cold bucket compile (a ``compile_stalls`` tick)."""
        now = self.clock()
        self._compiles = [t for t in self._compiles
                          if now - t < self.storm_window_s] + [now]

    def storming(self) -> bool:
        now = self.clock()
        self._compiles = [t for t in self._compiles
                          if now - t < self.storm_window_s]
        return len(self._compiles) >= self.storm_compiles

    def defer_cold(self, warm) -> bool:
        """True when a job whose program is not yet compiled (``warm``
        False) should wait out the current compile storm."""
        if warm or not self.storming():
            return False
        self.deferrals += 1
        telemetry.incr("admission_deferrals")
        return True

    def snapshot(self) -> dict:
        return {"storming": self.storming(),
                "rejections": int(self.rejections),
                "deferrals": int(self.deferrals)}


@dataclass
class SupervisorReport:
    """Outcome counters of one supervised run (also in ``metrics.jsonl``
    and the telemetry counters)."""

    attempts: int = 0
    retries: int = 0
    rollbacks: int = 0
    refolds: int = 0
    degradations: int = 0
    #: stall-class retries, budgeted apart from ``retries``
    stall_retries: int = 0
    #: "completed" | "preempted" (a resumable outcome, not a failure)
    status: str = "completed"
    backend: str = ""
    failures: list = field(default_factory=list)

    def as_dict(self):
        return asdict(self)


def _log_event(outdir, record):
    """Append to the run's ``metrics.jsonl`` (the chain store's file)."""
    p = Path(outdir)
    p.mkdir(parents=True, exist_ok=True)
    rec = {"ts": round(time.time(), 3), **record}
    with open(p / "metrics.jsonl", "a") as fh:
        fh.write(json.dumps(rec) + "\n")


def _degraded(gibbs):
    """The sampler to continue on after repeated device failures, or None
    to keep retrying this one.  The JAX package returns its NumPy oracle
    for a one-chain run; the port returns None for every run: a
    supervised run stays on its card, whatever its chains."""
    return None


def run_supervised(gibbs, x0, outdir, niter, save_every=100, resume=True,
                   max_retries=8, degrade_after=3, backoff_base=0.5,
                   backoff_cap=30.0, jitter=0.25, backoff_seed=0,
                   sleep=time.sleep, allow_degrade=True,
                   stall_max_retries=3, stall_backoff_base=None,
                   **sample_kwargs):
    """Drive ``gibbs.sample`` (a port facade) to ``niter`` under the retry
    policy above.  Returns ``(chain, report)``.

    ``sleep`` is injectable (tests capture the backoff schedule);
    ``resume`` applies to the first attempt (every retry resumes).  A
    ``preempted`` outcome returns at once with ``report.status ==
    "preempted"``: exit with ``preemption.EXIT_PREEMPTED`` so that the
    scheduler requeues.  Stalls retry under ``stall_max_retries`` (backoff
    base ``stall_backoff_base``, default ``backoff_base``) without using
    the general budget."""
    rep = SupervisorReport(backend=gibbs.backend_name)
    mesh = getattr(gibbs, "mesh", None)
    writer = mesh is None or mesh.rank == 0

    def agree(fn):
        """``fn()`` on the writer, its result on every rank."""
        out = fn() if writer else None
        return out if mesh is None else mesh.broadcast_object(out)

    def log(record):
        if writer:
            _log_event(outdir, record)

    consecutive_device = 0
    last_div_sig = None
    while True:
        rep.attempts += 1
        try:
            chain = gibbs.sample(x0, outdir=outdir, niter=niter,
                                 resume=resume or rep.attempts > 1,
                                 save_every=save_every, **sample_kwargs)
            rep.backend = gibbs.backend_name
            log({"event": "supervised_run_complete",
                                **rep.as_dict()})
            return chain, rep
        except KeyboardInterrupt:
            raise                # the facade's flush already ran
        except Exception as exc:
            kind = classify_failure(exc)
            if kind == "preempted":
                rep.status = "preempted"
                rep.backend = gibbs.backend_name
                log({
                    "event": "supervised_preempted",
                    "rows": getattr(exc, "rows", None),
                    "verified": getattr(exc, "verified", None),
                    "drain": preemption.drain_info(), **rep.as_dict()})
                return getattr(gibbs, "chain", None), rep
            fail = {"attempt": rep.attempts, "kind": kind,
                    "error": f"{type(exc).__name__}: {exc}"[:300]}
            rep.failures.append(fail)
            log({"event": "supervised_failure", **fail})
            if kind == "user":
                raise
            if kind == "stall":
                if rep.stall_retries >= stall_max_retries:
                    log({"event": "supervised_giving_up",
                                        "reason": "stall budget",
                                        **rep.as_dict()})
                    raise
                rep.stall_retries += 1
                telemetry.incr("stall_retries")
                delay = backoff_delay(
                    rep.stall_retries,
                    backoff_base if stall_backoff_base is None
                    else stall_backoff_base,
                    backoff_cap, jitter, seed=backoff_seed)
                log({"event": "supervised_retry",
                                    "next_attempt": rep.attempts + 1,
                                    "kind": kind,
                                    "stall_retry": rep.stall_retries,
                                    "backoff_s": round(delay, 3)})
                sleep(delay)
                continue
            if rep.retries >= max_retries:
                log({"event": "supervised_giving_up",
                                    **rep.as_dict()})
                raise
            rep.retries += 1
            telemetry.incr("retries")
            if kind == "corruption":
                # load_resume already tried the .bak: one more explicit
                # attempt, then give up
                if agree(lambda: integrity.rollback(outdir)):
                    rep.rollbacks += 1
                    log({"event": "checkpoint_rollback",
                                        "attempt": rep.attempts})
                else:
                    raise
            if kind == "divergence":
                sig = f"{type(exc).__name__}:{exc}"
                if sig == last_div_sig:
                    # the deterministic replay reproduced it: re-draw the
                    # stretch under a refolded seed
                    if agree(lambda: sentinels.refold_checkpoint_key(
                            outdir, salt=rep.attempts)):
                        rep.refolds += 1
                        log({"event": "prng_refold",
                                            "attempt": rep.attempts})
                last_div_sig = sig
            else:
                last_div_sig = None
            consecutive_device = (consecutive_device + 1
                                  if kind in ("device", "device_loss")
                                  else 0)
            if allow_degrade and consecutive_device >= degrade_after:
                down = _degraded(gibbs)
                if down is not None:
                    gibbs = down
                    rep.degradations += 1
                    rep.backend = gibbs.backend_name
                    telemetry.incr("degradations")
                    consecutive_device = 0
                    log({"event": "backend_degraded",
                                        "to": gibbs.backend_name,
                                        "attempt": rep.attempts})
            delay = backoff_delay(rep.retries, backoff_base, backoff_cap,
                                  jitter, seed=backoff_seed)
            log({"event": "supervised_retry",
                                "next_attempt": rep.attempts + 1,
                                "kind": kind,
                                "backoff_s": round(delay, 3)})
            sleep(delay)
