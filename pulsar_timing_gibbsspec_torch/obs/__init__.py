"""On-device streaming diagnostics and host-side trace/metrics export.

The port of ``pulsar_timing_gibbsspec_tpu/obs``, in two halves:

- **device half** (:mod:`.sketch`, finalized by :mod:`.summary`):
  streaming Chan moments and co-moments, lagged-product ACF sums and
  per-block move-rate sums, folded from the full-precision carry of
  every steady sweep, so ESS/ACT/R-hat come from a small state instead
  of shipped chains (``TorchGibbsDriver(obs=...)``, ``obs_summary()``);
- **host half** (:mod:`.trace`, :mod:`.metrics`, :mod:`.convergence`):
  nested monotonic trace spans around the driver's seams (Chrome /
  Perfetto ``trace.json``, ``metrics.jsonl`` lines), a Prometheus text
  writer over :mod:`..runtime.telemetry`, and exact rank-normalized
  split-R-hat on host record slabs;
- **the perf observatory** (:mod:`.perf`): streaming per-stage gauges
  off the trace observers, the anomaly-triggered ``torch.profiler``
  capture, and the append-only perf ledger.

:mod:`.trace` is stdlib-only and loaded eagerly (the driver touches it
every chunk); the others load on first attribute access.
"""

from . import trace  # noqa: F401

_LAZY = {
    "sketch": ".sketch",
    "summary": ".summary",
    "metrics": ".metrics",
    "convergence": ".convergence",
    "perf": ".perf",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name], __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
