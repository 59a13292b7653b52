"""Run-time support of the port: checkpoint integrity, telemetry,
divergence sentinels, the preemption drain, the dispatch watchdog,
deterministic fault injection, supervised runs, and the serving tier's
circuit breakers and admission control (the JAX package's ``runtime``,
without its lineage parts)."""

from . import (faults, integrity, preemption, sentinels, supervisor,
               telemetry, watchdog)
from .integrity import CheckpointError
from .preemption import EXIT_PREEMPTED, Preempted
from .sentinels import ChainDivergence, SentinelMonitor
from .supervisor import (AdmissionController, CircuitBreaker, CircuitOpen,
                         SupervisorReport, backoff_delay, classify_failure,
                         run_supervised)
from .watchdog import DispatchStall, DispatchWatchdog

__all__ = [
    "faults", "integrity", "preemption", "sentinels", "supervisor",
    "telemetry", "watchdog",
    "CheckpointError", "ChainDivergence", "SentinelMonitor",
    "SupervisorReport", "backoff_delay", "classify_failure",
    "run_supervised", "AdmissionController", "CircuitBreaker",
    "CircuitOpen",
    "EXIT_PREEMPTED", "Preempted", "DispatchStall", "DispatchWatchdog",
]
