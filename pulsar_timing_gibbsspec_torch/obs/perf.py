"""The performance observatory: streaming stage telemetry, anomaly
capture, and the durable perf ledger.

The port's copy of ``pulsar_timing_gibbsspec_tpu/obs/perf.py``, with the
same names and behaviour.  Three pieces, all riding the trace span seams
instead of adding instrumentation to the hot loop:

- :class:`StageAggregator`: a trace *observer* that folds every
  per-chunk pipeline-stage span (the driver's ``chunk.host_prep`` /
  ``chunk.dispatch`` / ``chunk.d2h`` / ``chunk.writeback`` and the
  service's ``serve.*`` twins) into bounded ring-buffer series and
  exports EMA / percentile gauges through :mod:`..runtime.telemetry`
  labels (``dispatch_ms{stage="device",stat="p90"[,job=...]}``), so
  ``SamplerService.prometheus()`` scrapes the live dispatch breakdown.
  Observers run outside the sampled computation: sampling outputs stay
  bitwise the same, and with no observer installed the span seams stay
  the shared ``nullcontext``.
- :class:`FlightRecorder`: anomaly-triggered capture.  When the
  watchdog soft-warns (``watchdog.soft`` instant) or a stage breaches
  its band (``perf.band_breach`` from the aggregator), it opens a
  bounded ``torch.profiler`` window and, after the next few chunks,
  merges the profiler's Chrome trace with the obs span timeline into
  one Perfetto file.
- the **perf ledger**: an append-only JSON-lines file of bench headline
  records, checked under explicit noise bands (:func:`check_ledger`).
  With no ``root``, :func:`ledger_path` is ``build/perf/ledger.jsonl``
  in the repository.
"""

from __future__ import annotations

import glob
import gzip
import json
import math
import os
import subprocess
import time
from pathlib import Path

import numpy as np

from ..runtime import telemetry
from . import trace as otrace

_REPO_ROOT = Path(__file__).resolve().parents[2]

# ---------------------------------------------------------------------------
# streaming stage telemetry


class RingSeries:
    """A bounded numeric time series: O(1) append into a fixed ring,
    EMA maintained online, percentiles over the retained window."""

    __slots__ = ("_buf", "_n", "_i", "ema", "_alpha", "count")

    def __init__(self, cap: int = 512, ema_alpha: float = 0.3):
        self._buf = np.empty(int(cap), np.float64)
        self._n = 0          # filled entries (<= cap)
        self._i = 0          # next write slot
        self.ema = None
        self._alpha = float(ema_alpha)
        self.count = 0       # total ever appended

    def append(self, v: float) -> None:
        v = float(v)
        self._buf[self._i] = v
        self._i = (self._i + 1) % len(self._buf)
        self._n = min(self._n + 1, len(self._buf))
        self.ema = v if self.ema is None else (
            self._alpha * v + (1.0 - self._alpha) * self.ema)
        self.count += 1

    def last(self) -> float | None:
        if not self._n:
            return None
        return float(self._buf[(self._i - 1) % len(self._buf)])

    def values(self) -> np.ndarray:
        return self._buf[: self._n].copy()

    def percentile(self, q) -> float:
        return float(np.percentile(self._buf[: self._n], q))

    def __len__(self) -> int:
        return self._n


#: span name -> pipeline stage.  ``chunk.dispatch`` is the *enqueue*
#: (the launches return once the work is queued), ``chunk.d2h`` the wait
#: for device results.  ``chunk.compile_dispatch`` and
#: ``serve.compile_dispatch`` (a graph capture) are deliberately absent:
#: a capture wall is not a steady-state stage.  ``chunk.carry_sync`` is
#: also unmapped: a sync point inside the dispatch pipeline, visible in
#: the Perfetto timeline, not a stage of its own.  A synthetic
#: ``dispatch_amortized`` stage (enqueue ms / sweeps per dispatch, from
#: the span's ``n=`` arg) is derived in :meth:`StageAggregator._on_event`.
SPAN_STAGES = {
    "chunk.host_prep": "host_prep",
    "chunk.dispatch": "enqueue",
    "chunk.d2h": "device",
    "chunk.writeback": "writeback",
    "serve.prepare": "host_prep",
    "serve.dispatch": "enqueue",
    "serve.d2h": "device",
    "serve.writeback": "writeback",
}

class StageAggregator:
    """Trace observer folding pipeline-stage spans into per-stage
    :class:`RingSeries` and ``dispatch_ms{stage=...,stat=...}`` gauges.

    ``band_k``, when set, arms the breach detector: a stage sample
    exceeding ``band_k`` x its prior EMA (after ``warm_n`` samples)
    emits a ``perf.band_breach`` instant, bumps the
    ``stage_band_breaches`` counter, and pokes ``recorder.trigger()``
    when a :class:`FlightRecorder` is attached.
    """

    def __init__(self, cap: int = 512, job: str | None = None,
                 ema_alpha: float = 0.3, band_k: float | None = None,
                 warm_n: int = 8, recorder=None):
        self.job = job
        self.band_k = band_k
        self.warm_n = int(warm_n)
        self.recorder = recorder
        self._series: dict[str, RingSeries] = {}
        self._cap = int(cap)
        self._alpha = float(ema_alpha)
        self._labels = {"job": job} if job is not None else {}

    # -- observer plumbing

    def install(self) -> "StageAggregator":
        otrace.add_observer(self._on_event)
        if self.recorder is not None:
            self.recorder.install()
        return self

    def uninstall(self) -> None:
        otrace.remove_observer(self._on_event)
        if self.recorder is not None:
            self.recorder.uninstall()

    def _on_event(self, ev: dict) -> None:
        if ev.get("ph") != "X":
            return
        stage = SPAN_STAGES.get(ev.get("name"))
        if stage is None:
            return
        ms = ev["dur"] / 1e3
        self.observe(stage, ms)
        if stage == "enqueue":
            # the driver's dispatch span carries the sweeps it covers
            # (``n=``): fold the amortized per-sweep dispatch cost as its
            # own stage
            n = (ev.get("args") or {}).get("n")
            if n:
                self.observe("dispatch_amortized", ms / int(n))

    # -- the fold

    def observe(self, stage: str, ms: float) -> None:
        s = self._series.get(stage)
        if s is None:
            s = self._series[stage] = RingSeries(self._cap, self._alpha)
        prior_ema, prior_n = s.ema, s.count
        s.append(ms)
        g = telemetry.gauge
        g("dispatch_ms", ms, stage=stage, stat="last", **self._labels)
        g("dispatch_ms", s.ema, stage=stage, stat="ema", **self._labels)
        for q, stat in ((50, "p50"), (90, "p90"), (99, "p99")):
            g("dispatch_ms", s.percentile(q), stage=stage, stat=stat,
              **self._labels)
        if (self.band_k is not None and prior_ema is not None
                and prior_n >= self.warm_n and ms > self.band_k * prior_ema):
            telemetry.incr("stage_band_breaches", stage=stage,
                           **self._labels)
            otrace.instant("perf.band_breach", stage=stage,
                           ms=round(ms, 3), ema=round(prior_ema, 3),
                           k=self.band_k)
            if self.recorder is not None:
                self.recorder.trigger(f"band_breach:{stage}")

    # -- export

    def summary(self) -> dict:
        """``{stage: {n, last, ema, p50, p90, p99}}`` for reports."""
        out = {}
        for stage, s in self._series.items():
            if not len(s):
                continue
            out[stage] = {"n": s.count, "last": s.last(), "ema": s.ema,
                          "p50": s.percentile(50), "p90": s.percentile(90),
                          "p99": s.percentile(99)}
        return out


# ---------------------------------------------------------------------------
# anomaly-triggered capture


class FlightRecorder:
    """Bounded anomaly capture: on a trigger (``watchdog.soft`` instant
    by default, or an explicit :meth:`trigger` from the aggregator's
    band detector), start a ``torch.profiler`` trace (CPU activity, and
    CUDA activity when a card is present) and stop it after the next
    ``window_chunks`` dispatch spans (or ``max_s`` seconds), merging the
    profiler's Chrome trace with the obs span timeline into one Perfetto
    file ``outdir/anomaly_<i>.trace.json``; the profiler's own trace
    lands in ``outdir/profile_<i>/``.  At most ``max_captures`` windows
    per recorder, so a flapping anomaly cannot fill the disk.  A
    profiler that fails to start is swallowed (the span timeline alone
    still lands).
    """

    #: spans that advance the capture window (one per chunk dispatch)
    _WINDOW_SPANS = ("chunk.dispatch", "chunk.compile_dispatch",
                     "serve.dispatch", "serve.compile_dispatch")

    def __init__(self, outdir, window_chunks: int = 4,
                 max_captures: int = 2, max_s: float = 60.0,
                 profiler: bool = True,
                 triggers=("watchdog.soft",)):
        self.outdir = Path(outdir)
        self.window_chunks = int(window_chunks)
        self.max_captures = int(max_captures)
        self.max_s = float(max_s)
        self.profiler = profiler
        self.triggers = tuple(triggers)
        self.captures: list = []     # merged-file paths, one per capture
        self._armed = False
        self._left = 0
        self._t0 = 0.0
        self._reason = None
        self._profiling = False
        self._prof = None
        self._window_events: list = []

    def install(self) -> "FlightRecorder":
        otrace.add_observer(self._on_event)
        return self

    def uninstall(self) -> None:
        otrace.remove_observer(self._on_event)
        if self._armed:
            self._finish()

    def _on_event(self, ev: dict) -> None:
        if self._armed:
            if len(self._window_events) < 10_000:
                self._window_events.append(ev)
            if (ev.get("ph") == "X"
                    and ev.get("name") in self._WINDOW_SPANS):
                self._left -= 1
            if self._left <= 0 or time.monotonic() - self._t0 > self.max_s:
                self._finish()
            return
        if ev.get("ph") == "i" and ev.get("name") in self.triggers:
            self.trigger(ev["name"])

    def trigger(self, reason: str) -> bool:
        """Arm a capture window.  Returns False when already armed or
        out of capture budget."""
        if self._armed or len(self.captures) >= self.max_captures:
            return False
        self._armed = True
        self._left = self.window_chunks
        self._t0 = time.monotonic()
        self._reason = reason
        self._window_events = []
        self.outdir.mkdir(parents=True, exist_ok=True)
        if self.profiler:
            try:
                self._prof = _start_profiler()
                self._profiling = True
            except Exception:
                self._prof = None
                self._profiling = False
        telemetry.incr("anomaly_captures")
        otrace.instant("perf.capture_start", reason=reason)
        return True

    def _profile_dir(self) -> Path:
        return self.outdir / f"profile_{len(self.captures)}"

    def _finish(self) -> None:
        if self._profiling:
            try:
                self._prof.stop()
                pdir = self._profile_dir()
                pdir.mkdir(parents=True, exist_ok=True)
                self._prof.export_chrome_trace(
                    str(pdir / "torch.trace.json"))
            except Exception:
                pass
            self._prof = None
            self._profiling = False
        out = self.outdir / f"anomaly_{len(self.captures)}.trace.json"
        # the full buffered timeline when the trace layer records;
        # otherwise the window this observer buffered itself
        spans = (otrace.events() if otrace.is_enabled()
                 else self._window_events)
        try:
            merge_perfetto(self._profile_dir(), out,
                           extra_events=spans,
                           meta={"reason": self._reason})
            self.captures.append(str(out))
        except Exception:
            self.captures.append(None)
        self._armed = False
        otrace.instant("perf.capture_done", path=str(out))


def _start_profiler():
    """A started ``torch.profiler.profile``: CPU activity, and CUDA
    activity when a card is present."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def merge_perfetto(profile_dir, out_path, extra_events=None,
                   meta=None) -> str:
    """Merge every ``*.trace.json[.gz]`` under ``profile_dir`` (the
    profiler's Chrome traces) with ``extra_events`` (obs span dicts)
    into one Chrome/Perfetto trace file.  Tolerates a missing or empty
    profiler dir: the span timeline alone still lands."""
    events: list = []
    profile_dir = os.fspath(profile_dir)
    paths = sorted(
        glob.glob(os.path.join(profile_dir, "**", "*.trace.json.gz"),
                  recursive=True)
        + glob.glob(os.path.join(profile_dir, "**", "*.trace.json"),
                    recursive=True))
    for p in paths:
        try:
            op = gzip.open if p.endswith(".gz") else open
            with op(p, "rt") as fh:
                doc = json.load(fh)
            events.extend(doc.get("traceEvents", []))
        except Exception:
            continue
    if extra_events:
        events.extend(extra_events)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        doc["metadata"] = dict(meta)
    out_path = os.fspath(out_path)
    with open(out_path, "w") as fh:
        json.dump(doc, fh)
    return out_path


# ---------------------------------------------------------------------------
# the durable perf ledger

#: bumped when a record's field meaning changes
LEDGER_SCHEMA = 1

#: headline fields copied verbatim into a ledger record when present
_HEADLINE_FIELDS = (
    "metric", "value", "unit", "vs_baseline", "device_kind", "backend",
    "sweeps_per_sec", "nchains", "mfu", "ess_per_sec",
    "ess_per_sec_device", "rho_act_median", "mesh_axes", "n_retraces",
    "dispatch_amortized_ms_per_sweep",
    "dispatch_breakdown_ms", "stage_summary",
)


def ledger_path(root=None) -> Path:
    """``root/PERF_LEDGER.jsonl``; with no ``root``,
    ``build/perf/ledger.jsonl`` in the repository."""
    if root:
        return Path(root) / "PERF_LEDGER.jsonl"
    return _REPO_ROOT / "build" / "perf" / "ledger.jsonl"


def git_sha() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=_REPO_ROOT,
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None
    except Exception:
        return None


def make_ledger_record(headline: dict, *, source: str, kind: str = "bench",
                       run: str | None = None, ts: float | None = None,
                       note: str | None = None) -> dict:
    """One append-only ledger line from a bench headline dict.  Heavy
    sub-objects are condensed: the roofline keeps per-block MFU/bound
    only, contract hashes come from the resilience block."""
    rec = {"schema": LEDGER_SCHEMA, "kind": kind, "source": source,
           "ts": time.time() if ts is None else ts}
    if rec["ts"] is not None:
        rec["ts_iso"] = _iso_ts(rec["ts"])
    if run:
        rec["run"] = run
    if note:
        rec["note"] = note
    for k in _HEADLINE_FIELDS:
        if headline.get(k) is not None:
            rec[k] = headline[k]
    roof = headline.get("roofline")
    if roof:
        rec["roofline"] = {
            name: {kk: r[kk] for kk in ("mfu", "intensity", "bound")
                   if kk in r}
            for name, r in roof.get("blocks", {}).items()}
    contracts = (headline.get("resilience") or {}).get(
        "jaxprcheck", {}).get("contracts")
    if contracts:
        rec["contract_hashes"] = contracts
    sha = git_sha()
    if sha:
        rec["git_sha"] = sha
    return rec


def _iso_ts(ts: float) -> str:
    """Host-side ISO-8601 UTC stamp for a ledger epoch ``ts``."""
    import datetime

    return datetime.datetime.fromtimestamp(
        float(ts), tz=datetime.timezone.utc
    ).isoformat(timespec="seconds").replace("+00:00", "Z")


def ledger_append(rec: dict, path=None) -> str:
    """Append one record, stamping the append time when the producer
    left ``ts`` null or absent (a record always carries a host-side
    timestamp).  Creates the ledger's directory."""
    if rec.get("ts") is None:
        rec = dict(rec, ts=time.time())
    if not rec.get("ts_iso"):
        rec = dict(rec, ts_iso=_iso_ts(rec["ts"]))
    path = Path(path or ledger_path())
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(rec, sort_keys=True) + "\n")
    return os.fspath(path)


def ledger_read(path=None) -> list[dict]:
    """All well-formed records, in file order.  Corrupt lines (torn
    appends) are skipped."""
    path = os.fspath(path or ledger_path())
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except Exception:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


# -- the regression gate

#: gated metrics with their default noise bands.  For rate fields
#: (bigger is better) the band is the allowed fractional DROP of HEAD
#: vs the best (highest) prior record in the same group; for the cost
#: fields in :data:`LOWER_IS_BETTER` it is the allowed fractional
#: GROWTH over the best (lowest) prior.  Wide on purpose: bench numbers
#: span hosts and load; the gate catches step regressions, not jitter.
DEFAULT_BANDS = {
    "value": 0.35,
    "sweeps_per_sec": 0.35,
    "ess_per_sec": 0.40,
    "ess_per_sec_device": 0.40,
    "dispatch_amortized_ms_per_sweep": 0.50,
}

#: fields where SMALLER is better: the gate bounds growth above the best
#: prior instead of a drop below it (a band override changes the width
#: only, never the direction)
LOWER_IS_BETTER = frozenset({"dispatch_amortized_ms_per_sweep"})


def _group_key(rec: dict) -> tuple:
    """Records compare only within (kind, metric, device, backend): a
    CPU smoke run never gates against the card's trajectory."""
    return (rec.get("kind", "bench"), rec.get("metric"),
            rec.get("device_kind"), rec.get("backend"))


def check_ledger(records: list[dict], bands: dict | None = None) -> list:
    """Noise-banded regression check over a ledger.

    Within each (kind, metric, device_kind, backend) group the newest
    record's rate fields must not fall more than the band fraction
    below the best prior value; :data:`LOWER_IS_BETTER` fields must not
    GROW more than the band above the best (lowest) prior.  New metrics,
    groups and fields (no prior) pass; ``multichip`` records must carry
    ``ok: true``.  Returns a list of problem strings: empty means the
    gate passes."""
    bands = {**DEFAULT_BANDS, **(bands or {})}
    problems: list = []
    groups: dict = {}
    multichip: list = []
    for rec in records:
        if rec.get("schema") is None:
            problems.append(f"record missing schema: {rec.get('run') or rec}")
            continue
        if rec.get("kind") == "multichip":
            multichip.append(rec)
            continue
        if rec.get("metric") is None:
            continue
        groups.setdefault(_group_key(rec), []).append(rec)
    # early failed multichip runs are history, not a regression; only
    # the trajectory's newest scaling record must be healthy
    if multichip and multichip[-1].get("ok") is False:
        problems.append(
            f"newest multichip run {multichip[-1].get('run')} recorded "
            "ok=false")
    for key, recs in groups.items():
        if len(recs) < 2:
            continue                      # new group: tolerated
        newest, prior = recs[-1], recs[:-1]
        for field, band in bands.items():
            new_v = newest.get(field)
            if new_v is None or not isinstance(new_v, (int, float)):
                continue
            prev = [r[field] for r in prior
                    if isinstance(r.get(field), (int, float))
                    and math.isfinite(r[field])]
            if not prev:
                continue                  # new field: tolerated
            if field in LOWER_IS_BETTER:
                best = min(prev)
                ceiling = (1.0 + band) * best
                if new_v > ceiling:
                    problems.append(
                        f"{key[1]} [{key[2]}/{key[3]}] {field}: newest "
                        f"{new_v:.4g} grew past noise band "
                        f"(best prior {best:.4g}, ceiling "
                        f"{ceiling:.4g}, band {band:.0%})")
                continue
            best = max(prev)
            floor = (1.0 - band) * best
            if new_v < floor:
                problems.append(
                    f"{key[1]} [{key[2]}/{key[3]}] {field}: newest "
                    f"{new_v:.4g} fell below noise band "
                    f"(best prior {best:.4g}, floor {floor:.4g}, "
                    f"band {band:.0%})")
    return problems
