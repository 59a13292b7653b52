"""Process-wide resilience counters and gauges.

The port's copy of ``pulsar_timing_gibbsspec_tpu/runtime/telemetry.py``:
one registry shared by the integrity layer, the sentinels, the driver and
the supervisor, so that retry, rollback and drain activity is visible in
one place, with the JAX package's counter names:

- ``retries``             supervisor attempts beyond the first
- ``rollbacks``           checkpoints restored from the ``.bak`` set
- ``refolds``             checkpoint seeds perturbed after a repeated
                          (deterministic) divergence
- ``torn_checkpoints``    chain/bchain row-count mismatches on resume
- ``corrupt_checkpoints`` manifest verification failures on resume
- ``sentinel_events``     non-fatal health warnings (acceptance collapse)
- ``sentinel_trips``      sentinel-raised divergences (stuck/non-finite)
- ``rho_bound_breaches``  chunks whose common rho left its prior bounds
- ``preempt_requests``    drain requests (signal or maintenance hook)
- ``preempt_drains``      drains completed to a verified checkpoint
- ``drain_abandoned_chunks``  in-flight chunks dropped at the deadline
- ``watchdog_soft``       a guarded wait past the soft deadline (logged)
- ``watchdog_dumps``      stack dumps at the hard deadline
- ``watchdog_stalls``     guarded waits abandoned as stalled
- ``stall_retries``       supervisor retries under the stall policy
- ``stage_band_breaches`` stage samples past ``band_k`` x their EMA
                          (labelled ``stage=``; obs.perf.StageAggregator)
- ``anomaly_captures``    flight-recorder windows opened (obs.perf)
- ``circuit_opens``       circuit breakers tripped open
- ``admission_rejections`` / ``admission_deferrals``  submissions refused
                          on backpressure / cold shapes held in a
                          compile storm (``AdmissionController``)
- ``serve_prewarms``      buckets the service built ahead of admission

Gauges (:func:`gauge`) hold last values: ``drain_latency_ms`` (request
to verified checkpoint of the last drain), ``chunk_wait_ms`` /
``chunk_wait_ema_ms`` (the driver's wait for each chunk to land once the
next is queued), ``watchdog_ema_s`` / ``watchdog_deadline_s``, and the
streaming stage gauges ``dispatch_ms{stage=,stat=}`` (obs.perf).

``incr``/``gauge`` and their getters take keyword labels, stored under
the composite key ``name{k="v",...}`` (Prometheus exposition syntax,
labels sorted); :func:`snapshot`, :func:`gauges` and :func:`reset` take a
``prefix`` matched against the base name.
"""

from __future__ import annotations

import threading

# an RLock: ``incr`` is reachable from the preemption signal handler,
# which can land while the main thread holds the lock in another call
_lock = threading.RLock()
_counts: dict[str, int] = {}
_gauges: dict[str, float] = {}


def _esc(v) -> str:
    """Prometheus label-value escaping (backslash, quote, newline, CR)."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n").replace("\r", "\\r")


def labeled(name: str, **labels) -> str:
    """The registry key of a labelled series (``name`` without labels)."""
    if not labels:
        return name
    lab = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
    return f"{name}{{{lab}}}"


def _base(key: str) -> str:
    return key.split("{", 1)[0]


def incr(name: str, n: int = 1, **labels) -> int:
    """Add ``n`` to counter ``name`` (created at 0); returns the new value."""
    key = labeled(name, **labels)
    with _lock:
        _counts[key] = _counts.get(key, 0) + int(n)
        return _counts[key]


def get(name: str, **labels) -> int:
    with _lock:
        return _counts.get(labeled(name, **labels), 0)


def gauge(name: str, value: float, **labels) -> None:
    """Record a last-value measurement (overwrites)."""
    with _lock:
        _gauges[labeled(name, **labels)] = float(value)


def get_gauge(name: str, default: float | None = None, **labels):
    with _lock:
        return _gauges.get(labeled(name, **labels), default)


def gauges(prefix: str | None = None) -> dict[str, float]:
    """Copy of the gauges, sorted by key; ``prefix`` filters base names."""
    with _lock:
        return dict(sorted((k, v) for k, v in _gauges.items()
                           if prefix is None or _base(k).startswith(prefix)))


def snapshot(prefix: str | None = None) -> dict[str, int]:
    """Copy of the counters, sorted by key; ``prefix`` filters base
    names."""
    with _lock:
        return dict(sorted((k, v) for k, v in _counts.items()
                           if prefix is None or _base(k).startswith(prefix)))


def reset(prefix: str | None = None) -> None:
    """Zero counters and gauges; with ``prefix``, only the series whose
    base name starts with it."""
    with _lock:
        if prefix is None:
            _counts.clear()
            _gauges.clear()
            return
        for d in (_counts, _gauges):
            for k in [k for k in d if _base(k).startswith(prefix)]:
                del d[k]
