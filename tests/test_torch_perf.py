"""The port's perf observatory (``pulsar_timing_gibbsspec_torch/obs/
perf.py``) against the JAX package's, on the CPU.

Classes: ``RingSeries`` statistics, the ``StageAggregator``'s gauges,
summary and breach verdicts on the same synthetic span stream, and
``check_ledger``'s verdicts on the same records: exact equality (the
same float64 arithmetic in NumPy on both sides).  The port's own: a run
with the aggregator observing is bitwise the run without (the service's
``perf=True`` and the driver's chunk spans), the ``FlightRecorder``'s
window, budget and ``max_s`` with and without ``torch.profiler``, and
the default ledger path under the git-ignored ``build/``.
"""

import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.data.simulate import synthetic_array
from pulsar_timing_gibbsspec_torch.obs import perf, trace
from pulsar_timing_gibbsspec_torch.runtime import telemetry
from pulsar_timing_gibbsspec_torch.serve import (BucketSpec, BucketTable,
                                                 ProgramCache,
                                                 SamplerService,
                                                 bench_dataset)

from pulsar_timing_gibbsspec_tpu.obs import perf as jperf
from pulsar_timing_gibbsspec_tpu.runtime import telemetry as jtelemetry

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


# -- RingSeries ---------------------------------------------------------------

@pytest.mark.parametrize("cap,alpha,n", [(512, 0.3, 40), (16, 0.3, 100),
                                         (7, 0.9, 23), (1, 0.05, 5)])
def test_ring_series_matches_jax(cap, alpha, n):
    vals = np.random.default_rng(cap + n).lognormal(0.0, 1.0, n)
    ours, ref = perf.RingSeries(cap, alpha), jperf.RingSeries(cap, alpha)
    for v in vals:
        ours.append(v)
        ref.append(v)
        assert ours.ema == ref.ema and ours.last() == ref.last()
        assert len(ours) == len(ref) and ours.count == ref.count
    np.testing.assert_array_equal(ours.values(), ref.values())
    for q in (0, 50, 90, 99, 100):
        assert ours.percentile(q) == ref.percentile(q)
    assert perf.RingSeries(4).last() is None


# -- StageAggregator ----------------------------------------------------------

def _span_stream(seed, n=120):
    """Chunk and serve spans (mapped and unmapped), instants, and slow
    write-backs late in the stream that breach a band."""
    rng = np.random.default_rng(seed)
    names = list(jperf.SPAN_STAGES) + ["chunk.compile_dispatch",
                                       "serve.compile_dispatch",
                                       "serve.restack", "chunk.carry_sync"]
    out = []
    for i in range(n):
        nm = names[rng.integers(len(names))]
        dur = float(rng.lognormal(7.0, 0.3))
        if i in (90, 110):
            nm, dur = "serve.writeback", 50.0 * dur
        args = {"n": int(rng.integers(1, 9))} if nm == "chunk.dispatch" \
            else {}
        out.append({"ph": "X", "name": nm, "ts": 1e3 * i, "dur": dur,
                    "pid": 1, "tid": 1, "args": args})
        if i % 7 == 0:
            out.append({"ph": "i", "name": "watchdog.soft", "ts": 1e3 * i,
                        "pid": 1, "tid": 1, "s": "t", "args": {}})
    return out


class _Triggers:
    def __init__(self):
        self.reasons = []

    def install(self):
        return self

    def uninstall(self):
        pass

    def trigger(self, reason):
        self.reasons.append(reason)
        return True


@pytest.mark.parametrize("band_k,warm_n,cap", [(None, 8, 512), (3.0, 8, 512),
                                               (2.0, 3, 5)])
def test_stage_aggregator_matches_jax(band_k, warm_n, cap):
    """The same span stream gives the same gauges, summary, breach
    counters and recorder triggers."""
    telemetry.reset()
    jtelemetry.reset()
    rec, jrec = _Triggers(), _Triggers()
    ours = perf.StageAggregator(cap=cap, job="t", band_k=band_k,
                                warm_n=warm_n, recorder=rec)
    ref = jperf.StageAggregator(cap=cap, job="t", band_k=band_k,
                                warm_n=warm_n, recorder=jrec)
    for ev in _span_stream(int(warm_n)):
        ours._on_event(dict(ev))
        ref._on_event(dict(ev))
    assert ours.summary() == ref.summary()
    assert set(ours.summary()) >= {"host_prep", "enqueue", "device",
                                   "writeback", "dispatch_amortized"}
    assert telemetry.gauges("dispatch_ms") == jtelemetry.gauges("dispatch_ms")
    assert telemetry.snapshot("stage_band_breaches") == \
        jtelemetry.snapshot("stage_band_breaches")
    assert rec.reasons == jrec.reasons
    assert bool(rec.reasons) == (band_k is not None)
    telemetry.reset()
    jtelemetry.reset()


# -- the ledger ---------------------------------------------------------------

def _rec(metric, t, **kw):
    return dict({"schema": 1, "kind": "bench", "metric": metric,
                 "device_kind": "NVIDIA H100 80GB HBM3", "backend": "torch",
                 "ts": float(t)}, **kw)


_LEDGERS = {
    "steady": [_rec("a", 0, value=100.0, sweeps_per_sec=10.0),
               _rec("a", 1, value=95.0, sweeps_per_sec=9.0)],
    "drop": [_rec("a", 0, value=100.0), _rec("a", 1, value=120.0),
             _rec("a", 2, value=70.0, ess_per_sec=1.0)],
    "lower_is_better": [
        _rec("a", 0, dispatch_amortized_ms_per_sweep=1.0),
        _rec("a", 1, dispatch_amortized_ms_per_sweep=0.8),
        _rec("a", 2, dispatch_amortized_ms_per_sweep=1.3)],
    "groups_apart": [_rec("a", 0, value=100.0),
                     _rec("a", 1, value=10.0, device_kind="cpu"),
                     _rec("b", 2, value=1.0)],
    "nan_prior": [_rec("a", 0, value=float("nan")), _rec("a", 1, value=1.0),
                  _rec("a", 2, value=0.5)],
    "multichip": [{"schema": 1, "kind": "multichip", "run": "r1",
                   "ok": False},
                  {"schema": 1, "kind": "multichip", "run": "r2",
                   "ok": True},
                  {"schema": 1, "kind": "multichip", "run": "r3",
                   "ok": False}],
    "no_schema": [{"metric": "a", "value": 1.0, "run": "x"},
                  {"kind": "bench", "value": 2.0}],
}


@pytest.mark.parametrize("bands", [None, {"value": 0.05},
                                   {"dispatch_amortized_ms_per_sweep": 0.1}],
                         ids=["default", "tight_value", "tight_dispatch"])
@pytest.mark.parametrize("name", sorted(_LEDGERS))
def test_check_ledger_matches_jax(name, bands):
    recs = _LEDGERS[name]
    got = perf.check_ledger(recs, bands)
    assert got == jperf.check_ledger(recs, bands)
    if name == "steady" and bands is None:
        assert got == []


def test_ledger_record_append_read_match_jax(tmp_path):
    head = {"metric": "gibbs_samples_per_sec_45psr_pta", "value": 1536.8,
            "unit": "samples/s", "device_kind": "NVIDIA H100 80GB HBM3",
            "backend": "torch", "sweeps_per_sec": 24.0, "nchains": 64,
            "roofline": {"blocks": {"white": {"mfu": 0.1, "bound": "bytes",
                                              "extra": 1}}},
            "resilience": {"jaxprcheck": {"contracts": {"sweep": "ab"}}},
            "ignored": 3}
    ours = perf.make_ledger_record(head, source="t", run="r", ts=5.0,
                                   note="n")
    ref = jperf.make_ledger_record(head, source="t", run="r", ts=5.0,
                                   note="n")
    assert ours == ref
    path = tmp_path / "ledger.jsonl"
    perf.ledger_append(ours, path)
    perf.ledger_append(dict(ours, ts=None, ts_iso=None), path)
    with open(path, "a") as fh:
        fh.write("{torn\n\n")
    assert perf.ledger_read(path) == jperf.ledger_read(path)
    got = perf.ledger_read(path)
    assert len(got) == 2 and got[0] == ours and got[1]["ts"] > 5.0
    assert perf.ledger_read(tmp_path / "absent.jsonl") == []


def test_default_ledger_lies_under_ignored_build(tmp_path):
    """With no ``root`` the port's ledger is a file under ``build/``,
    which git ignores; with a ``root`` it is the JAX package's name."""
    p = perf.ledger_path()
    assert p.relative_to(ROOT).parts[0] == "build"
    got = subprocess.run(["git", "check-ignore", "-q", str(p)], cwd=ROOT)
    assert got.returncode == 0, f"{p} is not ignored by git"
    assert perf.ledger_path(tmp_path) == jperf.ledger_path(tmp_path)


# -- the flight recorder ------------------------------------------------------

def _span(name, dur_us=1000.0, **args):
    return {"ph": "X", "name": name, "ts": 0.0, "dur": dur_us, "pid": 1,
            "tid": 1, "args": args}


def test_flight_recorder_window_and_budget(tmp_path):
    """Without the profiler: a band breach opens one window, closed by
    the next ``window_chunks`` dispatch spans into a merged file with the
    buffered spans; past ``max_captures`` a trigger is refused.  The JAX
    recorder gives the same answers on the same stream."""
    outs = {}
    for name, mod, tel in (("port", perf, telemetry),
                           ("jax", jperf, jtelemetry)):
        tel.reset()
        rec = mod.FlightRecorder(tmp_path / name, window_chunks=2,
                                 max_captures=1, profiler=False)
        agg = mod.StageAggregator(job="fr", band_k=3.0, warm_n=4,
                                  recorder=rec)
        agg.install()
        try:
            for _ in range(6):
                agg._on_event(_span("serve.writeback"))
            agg._on_event(_span("serve.writeback", 50_000.0))
            armed = rec._armed
            for i in range(2):
                rec._on_event(_span("serve.dispatch", chunk=i))
            again = rec.trigger("manual")
        finally:
            agg.uninstall()
        doc = json.loads(Path(rec.captures[0]).read_text())
        assert doc["metadata"] == {"reason": "band_breach:writeback"}
        outs[name] = (armed, len(rec.captures), again,
                      tel.get("anomaly_captures"),
                      tel.get("stage_band_breaches", job="fr",
                              stage="writeback"),
                      [e["name"] for e in doc["traceEvents"]])
        tel.reset()
    assert outs["port"] == outs["jax"]
    assert outs["port"][:5] == (True, 1, False, 1, 1)
    assert outs["port"][5].count("serve.dispatch") == 2


def test_flight_recorder_max_s_and_instant_trigger(tmp_path):
    """A ``watchdog.soft`` instant arms the window; past ``max_s`` the
    next event closes it without a dispatch span."""
    import time

    rec = perf.FlightRecorder(tmp_path, max_s=0.2, profiler=False).install()
    try:
        trace.instant("watchdog.soft", what="probe")
        assert rec._armed
        time.sleep(0.25)
        with trace.span("serve.d2h", chunk=1):
            pass
        assert not rec._armed and len(rec.captures) == 1
    finally:
        rec.uninstall()
    names = [e["name"] for e in
             json.loads(Path(rec.captures[0]).read_text())["traceEvents"]]
    assert names == ["perf.capture_start", "serve.d2h"]


def test_flight_recorder_torch_profiler_on_cpu(tmp_path):
    """With the profiler on a host without a card, the window's torch
    operators land in the merged file beside the obs spans (the card's
    device events are held by ``chip_smoke.py`` phase 23)."""
    rec = perf.FlightRecorder(tmp_path, window_chunks=1).install()
    try:
        assert rec.trigger("manual")
        a = torch.ones(64, 64)
        (a @ a).sum().item()
        with trace.span("serve.dispatch", chunk=1):
            pass
    finally:
        rec.uninstall()
    assert len(list((tmp_path / "profile_0").glob("*.trace.json"))) == 1
    evs = json.loads(Path(rec.captures[0]).read_text())["traceEvents"]
    names = {e.get("name") for e in evs}
    assert "serve.dispatch" in names
    assert any(str(n).startswith("aten::") for n in names)


# -- bitwise inert ------------------------------------------------------------

NB = 3
TABLE = BucketTable([BucketSpec(3, 48, 24, NB)])


def _service_chains(tmp_path, perf_on, cache):
    data = [bench_dataset(synthetic_array(npsr=2, seed=s, ntoa_min=24,
                                          ntoa_max=n), NB, NB)
            for s, n in ((0, 40), (1, 30), (2, 36))]
    svc = SamplerService(tmp_path / f"perf{int(perf_on)}", TABLE, slots=2,
                         chunk=4, quantum=2, cache=cache, device="cpu",
                         perf=perf_on)
    jobs = [svc.submit(d, 12, tenant_id=i) for i, d in enumerate(data)]
    rep = svc.run()
    svc.close()
    return [(j.chain, j.bchain) for j in jobs], rep


def _driver_chains(tmp_path, perf_on):
    from pulsar_timing_gibbsspec_torch import (PTABlockGibbs,
                                               build_crn_spectrum)

    cm = build_crn_spectrum(synthetic_array(npsr=2, seed=0, ntoa_min=24,
                                            ntoa_max=40), 3, 3,
                            device="cpu")
    g = PTABlockGibbs(cm, nchains=2, device="cpu", seed=0, warmup_sweeps=2,
                      white_adapt_iters=20, chunk_size=5, progress=False)
    x0 = g.initial_sample(torch.Generator().manual_seed(0))
    agg = perf.StageAggregator(job="drv").install() if perf_on else None
    try:
        chain = g.sample(x0, outdir=str(tmp_path / f"drv{int(perf_on)}"),
                         niter=14, save_every=5)
    finally:
        if agg is not None:
            agg.uninstall()
    return [(np.asarray(chain), None)], (agg.summary() if agg else None)


@pytest.mark.parametrize("path", ["service", "driver"])
def test_perf_is_bitwise_inert(tmp_path, path):
    """The port's form of the JAX ``test_stage_aggregator_bitwise_inert``:
    the run with the aggregator observing every span is bitwise the run
    without, and the aggregator saw the pipeline's stages."""
    telemetry.reset("dispatch_ms")
    if path == "service":
        cache = ProgramCache()
        off, _ = _service_chains(tmp_path, False, cache)
        on, rep = _service_chains(tmp_path, True, cache)
        summ, job = rep["stage_summary"], "svc"
        assert "stage_summary" not in _service_chains(
            tmp_path / "again", False, cache)[1]
    else:
        off, _ = _driver_chains(tmp_path, False)
        on, summ = _driver_chains(tmp_path, True)
        job = "drv"
        assert summ["dispatch_amortized"]["n"] == summ["enqueue"]["n"]
    for (a, ab), (b, bb) in zip(off, on):
        assert a.tobytes() == b.tobytes()
        if ab is not None:
            assert ab.tobytes() == bb.tobytes()
    assert {"host_prep", "enqueue", "device", "writeback"} <= set(summ)
    for stage in summ:
        assert telemetry.get_gauge("dispatch_ms", job=job, stage=stage,
                                   stat="p90") is not None
    assert not trace._observers
    telemetry.reset("dispatch_ms")
