"""The serving guards of the port (``runtime/supervisor.py``'s
``CircuitBreaker`` and ``AdmissionController``, and the service's
``breaker=``, ``admission=`` and ``prewarm=``) and its trace spans,
against the JAX package's, on the CPU.

- the breaker and the controller, driven by the same event and clock
  sequence as the JAX ``tests/test_quarantine.py``: identical answers,
  exceptions and ``snapshot()`` sequences;
- the service cases of the JAX ``tests/test_quarantine.py`` (the breaker
  gates re-admission and submit, the probe survives a group mismatch,
  the storm defers cold shapes, backpressure refuses submit) and the
  single-slice prewarm case of ``tests/test_placement.py``, each run on
  the port and on the JAX service with the same submissions and the
  same counting clock: equal reports (job states and rows, chunk
  counts, the quarantine log, breakers, admission, prewarms and the
  per-bucket warmth) and equal sets of ``serve.*`` span names and
  ``args`` keys; the port's chains bitwise its solo runs.

Datasets: 2 synthetic pulsars under ``bench.py``'s CRN model with 3
modes, in buckets of 3 pulsars with 48 or 64 TOAs; 2 slots, chunks of 4.
"""

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.data.simulate import synthetic_array
from pulsar_timing_gibbsspec_torch.obs import trace
from pulsar_timing_gibbsspec_torch.runtime import faults, preemption
from pulsar_timing_gibbsspec_torch.runtime.supervisor import (
    AdmissionController, CircuitBreaker, CircuitOpen)
from pulsar_timing_gibbsspec_torch.serve import (BucketSpec, BucketTable,
                                                 ProgramCache,
                                                 SamplerService,
                                                 bench_dataset)

from pulsar_timing_gibbsspec_tpu.obs import trace as jtrace
from pulsar_timing_gibbsspec_tpu.runtime import faults as jfaults
from pulsar_timing_gibbsspec_tpu.runtime import preemption as jpreemption
from pulsar_timing_gibbsspec_tpu.runtime import supervisor as jsup
from test_torch_cases import jax_pta

torch.set_num_threads(2)

NITER = 12
NB = 3
B1, B2 = (3, 48, 24, NB), (3, 64, 24, NB)


def _psrs(seed, ntoa_min, ntoa_max):
    return synthetic_array(npsr=2, seed=seed, ntoa_min=ntoa_min,
                           ntoa_max=ntoa_max)


#: (seed, fewest TOAs, most TOAs): bucket B1, then bucket B2
_SPECS = {"a0": (0, 24, 40), "a1": (1, 24, 30), "b0": (9, 50, 60),
          "b1": (8, 50, 62)}


@pytest.fixture(scope="module")
def psrs():
    return {k: _psrs(*v) for k, v in _SPECS.items()}


def _clock():
    """The JAX tests' counting clock: each read advances 10 ms, so a
    cooldown or a storm window ends after a fixed number of reads."""
    tick = {"n": 0}

    def clock():
        tick["n"] += 1
        return 0.01 * tick["n"]
    return clock


# -- the state machines -------------------------------------------------------

def _drive(obj, script, t):
    """Apply ``script`` (method name and arguments, or ``("t", now)``)
    and record each answer (or the exception's type and text) with the
    snapshot after it."""
    out = []
    for op, *args in script:
        if op == "t":
            t["now"] = args[0]
            continue
        try:
            got = getattr(obj, op)(*args)
        except CircuitOpen as exc:          # the port's class
            got = ("CircuitOpen", str(exc))
        except jsup.CircuitOpen as exc:     # the JAX package's class
            got = ("CircuitOpen", str(exc))
        out.append((op, got, obj.snapshot(), getattr(obj, "state", None)))
    return out


_BREAKER = [
    ("allow",), ("record_failure",), ("record_failure",), ("allow",),
    ("would_allow",), ("check", "tenant 7"), ("t", 10.0), ("would_allow",),
    ("allow",), ("allow",), ("record_failure",), ("t", 20.0), ("allow",),
    ("record_success",), ("allow",), ("record_success",),
    ("record_failure",), ("record_success",), ("record_failure",),
    ("check", "tenant 7"), ("t", 25.0), ("check", "tenant 7"),
    ("t", 31.0), ("check", "tenant 7"), ("would_allow",), ("allow",),
    ("would_allow",), ("check", "tenant 7"), ("record_success",),
]


def _random_script(seed, n=200):
    rng = np.random.default_rng(seed)
    ops = ["allow", "would_allow", "record_failure", "record_success",
           "check"]
    out, now = [], 0.0
    for _ in range(n):
        if rng.random() < 0.15:
            now += float(rng.choice([0.5, 3.0, 11.0]))
            out.append(("t", now))
        op = ops[rng.integers(len(ops))]
        out.append((op, "tenant 3") if op == "check" else (op,))
    return out


@pytest.mark.parametrize("script", ["jax_test", "random0", "random1"])
@pytest.mark.parametrize("cfg", [
    dict(window=4, threshold=0.5, min_events=2, cooldown_s=10.0),
    dict(window=3, threshold=1.0, min_events=1, cooldown_s=2.0)],
    ids=["w4", "w3"])
def test_circuit_breaker_matches_jax(cfg, script):
    """``tests/test_quarantine.py::test_circuit_breaker_state_machine``'s
    sequence (and two seeded random ones): the same answers, raises and
    snapshots, step for step."""
    seq = _BREAKER if script == "jax_test" else \
        _random_script(int(script[-1]))
    t, tj = {"now": 0.0}, {"now": 0.0}
    ours = CircuitBreaker(clock=lambda: t["now"], **cfg)
    ref = jsup.CircuitBreaker(clock=lambda: tj["now"], **cfg)
    got, want = _drive(ours, seq, t), _drive(ref, seq, tj)
    assert got == want
    assert ours.opens == ref.opens >= 1


def test_breaker_half_open_single_probe_under_concurrency():
    """The port's form of the JAX race test: threads racing ``allow()``
    (with ``would_allow`` queries mixed in) claim the single half-open
    probe exactly once."""
    import sys
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(10):
            br = CircuitBreaker(window=4, threshold=0.5, min_events=2,
                                cooldown_s=0.0)
            br.record_failure()
            br.record_failure()
            n = 8
            barrier = threading.Barrier(n)
            wins = []

            def racer():
                barrier.wait()
                for _ in range(25):
                    br.would_allow()
                wins.append(br.allow())

            threads = [threading.Thread(target=racer) for _ in range(n)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            assert not any(th.is_alive() for th in threads)
            assert sum(wins) == 1 and br.state == "half_open"
    finally:
        sys.setswitchinterval(old)


_ADMISSION = [
    ("admit_submission", 1), ("admit_submission", 2), ("storming",),
    ("note_compile",), ("defer_cold", False), ("note_compile",),
    ("storming",), ("defer_cold", False), ("defer_cold", True),
    ("admit_submission", 7), ("t", 4.0), ("note_compile",),
    ("defer_cold", False), ("t", 6.0), ("storming",),
    ("defer_cold", False), ("t", 9.5), ("storming",),
    ("defer_cold", False), ("admit_submission", 0),
]


@pytest.mark.parametrize("cfg", [
    dict(max_queue=2, storm_compiles=2, storm_window_s=5.0),
    dict(max_queue=6, storm_compiles=1, storm_window_s=1.0)],
    ids=["jax_test", "one_compile"])
def test_admission_controller_matches_jax(cfg):
    """``tests/test_quarantine.py::
    test_admission_controller_backpressure_and_storm``'s sequence,
    extended: the same answers, raises and snapshots."""
    t, tj = {"now": 0.0}, {"now": 0.0}
    ours = AdmissionController(clock=lambda: t["now"], **cfg)
    ref = jsup.AdmissionController(clock=lambda: tj["now"], **cfg)
    got = _drive(ours, _ADMISSION, t)
    assert got == _drive(ref, _ADMISSION, tj)
    assert ours.deferrals >= 1 and ours.rejections >= 1


# -- the service on both packages ---------------------------------------------

_JCACHE = None


def _jax_cache():
    """A cold JAX program cache (no canonical model: a bucket's first
    admission is a cold compile, as on the port's fresh cache) that
    shares the module's jitted multiplexed chunk and b-init, which XLA
    compiles once per shape."""
    global _JCACHE
    from pulsar_timing_gibbsspec_tpu.serve import ProgramCache as JC

    if _JCACHE is None:
        _JCACHE = JC()
    c = JC()
    c._mux, c._init = _JCACHE._mux, _JCACHE.init_fn()
    return c


def _tables(buckets):
    from pulsar_timing_gibbsspec_tpu.serve import BucketSpec as JB
    from pulsar_timing_gibbsspec_tpu.serve import BucketTable as JT

    return (BucketTable([BucketSpec(*b) for b in buckets]),
            JT([JB(*b) for b in buckets]))


def _services(root, buckets, clock=None, **kw):
    """The port's service (on the CPU) and the JAX one, same options,
    each on a cold cache."""
    from pulsar_timing_gibbsspec_tpu.serve import SamplerService as JS

    kw.setdefault("slots", 2)
    kw.setdefault("chunk", 4)
    kw.setdefault("quantum", 100)
    tp, tj = _tables(buckets)
    ck = (lambda: None) if clock is None else clock
    extra = {} if clock is None else {"clock": ck()}
    ours = SamplerService(root / "port", tp, device="cpu",
                          cache=ProgramCache(), **extra, **kw)
    extra = {} if clock is None else {"clock": ck()}
    ref = JS(root / "jax", tj, cache=_jax_cache(), **extra, **kw)
    return ours, ref


def _jpta(psrs):
    return jax_pta(psrs, NB, NB)


class _Spans:
    """The ``(ph, name, args keys)`` of every ``serve.*`` event one
    package's trace emits while installed."""

    def __init__(self, mod):
        self.mod, self.seen = mod, set()

    def _ev(self, ev):
        if ev["name"].startswith("serve."):
            self.seen.add((ev["ph"], ev["name"], tuple(sorted(ev["args"]))))

    def __enter__(self):
        self.mod.add_observer(self._ev)
        return self

    def __exit__(self, *exc):
        self.mod.remove_observer(self._ev)
        return False


def _view(rep, jax_side):
    """The report's keys both services share, without wall-clock values;
    the JAX ``placement`` block's prewarms and warmth at the top."""
    jobs = {k: {f: v for f, v in j.items()
                if f != "time_to_first_sample_ms"}
            for k, j in rep["jobs"].items()}
    out = {k: rep[k] for k in ("chunks", "evictions", "compile_stalls",
                               "warm_hit_rate", "service_retries",
                               "quarantines", "quarantine_log", "breakers",
                               "admission")}
    src = rep["placement"] if jax_side else rep
    out.update(jobs=jobs, prewarms=src["prewarms"], groups=src["groups"])
    return out


def _both(case, ours, ref, psrs):
    """Run ``case(svc, data_fn, faults_mod, preemption_mod)`` on both
    services under their trace observers; returns the reports' shared
    views and the span sets."""
    res = []
    for svc, mk, fmod, pmod, tmod, jax_side in (
            (ours, lambda k: bench_dataset(psrs[k], NB, NB), faults,
             preemption, trace, False),
            (ref, lambda k: _jpta(psrs[k]), jfaults, jpreemption, jtrace,
             True)):
        fmod.clear()
        try:
            with _Spans(tmod) as sp:
                jobs, rep = case(svc, mk, fmod, pmod)
        finally:
            fmod.clear()
        res.append((jobs, _view(rep, jax_side), sp.seen))
    return res


@pytest.fixture(scope="module")
def solo(psrs, tmp_path_factory):
    """Each dataset alone on the port (2 slots): its chain and bchain."""
    base = tmp_path_factory.mktemp("solo")
    cache = ProgramCache()
    out = {}
    for i, key in enumerate(sorted(psrs)):
        tp, _ = _tables([B1, B2])
        svc = SamplerService(base / key, tp, slots=2, chunk=4, quantum=100,
                             cache=cache, device="cpu")
        job = svc.submit(bench_dataset(psrs[key], NB, NB), NITER,
                         tenant_id=i)
        svc.run()
        assert job.state == "done"
        out[key] = (job.chain.copy(), job.bchain.copy())
    return out


_TENANT = {k: i for i, k in enumerate(sorted(_SPECS))}


def _bitwise(jobs, solo, keys):
    for key, job in zip(keys, jobs):
        assert job.state == "done", (key, job.state, job.failure)
        np.testing.assert_array_equal(job.chain, solo[key][0])
        np.testing.assert_array_equal(job.bchain, solo[key][1])


def test_breaker_gates_readmission_and_submit(psrs, solo, tmp_path):
    """The JAX ``test_breaker_gates_readmission_and_submit``: a poisoned
    tenant quarantines, waits out its breaker's cooldown, is readmitted
    through the half-open probe and closes it; a tenant whose breaker is
    open is refused at submit, typed."""
    ours, ref = _services(tmp_path, [B1], clock=_clock, save_every=1,
                          breaker={"window": 4, "threshold": 1.0,
                                   "min_events": 1, "cooldown_s": 0.05})
    keys = ("a0", "a1")

    def case(svc, mk, fmod, _):
        fmod.inject("poison_rows", tenant=_TENANT["a1"], at_row=1, times=1)
        jobs = [svc.submit(mk(k), NITER, job_id=k, tenant_id=_TENANT[k])
                for k in keys]
        return jobs, svc.run()

    (jobs, got, spans), (_, want, jspans) = _both(case, ours, ref, psrs)
    assert got == want
    assert spans == jspans
    assert ("i", "serve.quarantine",
            ("count", "job", "tenant", "why")) in spans
    br = got["breakers"][_TENANT["a1"]]
    assert br["opens"] == 1 and br["state"] == "closed"
    _bitwise(jobs, solo, keys)

    msgs = []
    for side in _services(tmp_path / "open", [B1], save_every=1,
                          breaker={"window": 4, "threshold": 1.0,
                                   "min_events": 1, "cooldown_s": 60.0}):
        side._tenant_breaker(9, create=True).record_failure()
        data = bench_dataset(psrs["a0"], NB, NB) \
            if isinstance(side, SamplerService) else _jpta(psrs["a0"])
        with pytest.raises((CircuitOpen, jsup.CircuitOpen),
                           match="tenant 9") as exc:
            side.submit(data, 4, tenant_id=9)
        msgs.append(str(exc.value).split(" — ")[0])
    assert msgs[0] == msgs[1]


def test_breaker_probe_survives_group_mismatch(psrs, solo, tmp_path):
    """The JAX regression: while a tenant of another bucket holds the
    slots, the quarantined tenant's cooldown elapses; the probe is
    claimed only at its admission, so the tenant finishes and its
    breaker closes."""
    ours, ref = _services(tmp_path, [B1, B2], clock=_clock,
                          save_every=1,
                          breaker={"window": 4, "threshold": 1.0,
                                   "min_events": 1, "cooldown_s": 0.05})

    def case(svc, mk, fmod, _):
        fmod.inject("poison_rows", tenant=_TENANT["a0"], at_row=1, times=1)
        ja = svc.submit(mk("a0"), NITER, job_id="victim",
                        tenant_id=_TENANT["a0"])
        jb = svc.submit(mk("b0"), 28, job_id="other",
                        tenant_id=_TENANT["b0"])
        for _ in range(200):
            if not svc.step() and not svc.queue:
                break
        return [ja, jb], svc.report()

    (jobs, got, spans), (_, want, jspans) = _both(case, ours, ref, psrs)
    assert got == want and spans == jspans
    assert [j.state for j in jobs] == ["done", "done"]
    br = got["breakers"][_TENANT["a0"]]
    assert br["opens"] == 1 and br["state"] == "closed"
    _bitwise(jobs[:1], solo, ("a0",))


def test_admission_storm_defers_cold_shapes(psrs, solo, tmp_path):
    """During a compile storm a cold bucket is deferred, and admitted
    once the storm window drains."""
    ours, ref = _services(tmp_path, [B1, B2], clock=_clock,
                          admission={"max_queue": 8, "storm_compiles": 1,
                                     "storm_window_s": 0.5})

    def case(svc, mk, fmod, _):
        jobs = [svc.submit(mk(k), NITER, job_id=k, tenant_id=_TENANT[k])
                for k in ("a0", "b0")]
        return jobs, svc.run()

    (jobs, got, spans), (_, want, jspans) = _both(case, ours, ref, psrs)
    assert got == want and spans == jspans
    assert got["admission"]["deferrals"] >= 1
    _bitwise(jobs, solo, ("a0", "b0"))


def test_admission_backpressure_rejects_submit(psrs, tmp_path):
    outs = []
    for side in _services(tmp_path, [B1], admission={"max_queue": 2}):
        port = isinstance(side, SamplerService)

        def mk(k):
            return bench_dataset(psrs[k], NB, NB) if port \
                else _jpta(psrs[k])
        side.submit(mk("a0"), 4, tenant_id=0)
        side.submit(mk("a1"), 4, tenant_id=1)
        with pytest.raises((CircuitOpen, jsup.CircuitOpen),
                           match="backpressure") as exc:
            side.submit(mk("a0"), 4, tenant_id=2)
        outs.append((str(exc.value), side.report()["admission"],
                     len(side.jobs)))
    assert outs[0] == outs[1]
    assert outs[0][1]["rejections"] == 1


def test_prewarm_builds_waiting_bucket_under_cap(psrs, solo, tmp_path):
    """The JAX ``test_prewarm_compiles_waiting_bucket_under_cap`` on one
    slice: with both slots held by group A on a cold cache, the queued
    group-B job is prebuilt once (the cap), so B admits with no miss."""
    ours, ref = _services(tmp_path, [B1, B2], prewarm=1)
    keys = ("a0", "a1", "b0", "b1")

    def case(svc, mk, fmod, _):
        jobs = [svc.submit(mk(k), 8, job_id=k, tenant_id=_TENANT[k])
                for k in keys]
        return jobs, svc.run()

    (jobs, got, spans), (_, want, jspans) = _both(case, ours, ref, psrs)
    assert got == want and spans == jspans
    assert ("X", "serve.prewarm", ("bucket", "job")) in spans
    assert got["prewarms"] == 1
    b = str(B2)
    assert got["groups"][b]["misses"] == 0
    assert got["groups"][b]["warm_hit_rate"] == 1.0
    for key, job in zip(keys, jobs):
        assert job.state == "done"
        np.testing.assert_array_equal(job.chain, solo[key][0][:8])


def test_span_names_match_jax(psrs, tmp_path):
    """One run through every stage (cold builds, a prewarm, a poisoned
    tenant, the drain): the port emits the JAX service's ``serve.*``
    span and instant names with the same ``args`` keys."""
    ours, ref = _services(tmp_path, [B1, B2], clock=_clock,
                          save_every=1, prewarm=1, breaker=True,
                          admission={"max_queue": 8})

    def case(svc, mk, fmod, pmod):
        fmod.inject("poison_rows", tenant=_TENANT["a1"], at_row=1, times=1)
        jobs = [svc.submit(mk(k), NITER, job_id=k, tenant_id=_TENANT[k])
                for k in ("a0", "a1", "b0")]
        for _ in range(3):
            svc.step()
        pmod.request_drain()
        try:
            with pytest.raises(pmod.Preempted):
                svc.step()
        finally:
            pmod.reset()
        return jobs, svc.report()

    (_, got, spans), (_, want, jspans) = _both(case, ours, ref, psrs)
    assert spans == jspans
    assert got == want
    assert {n for _, n, _ in spans} == {
        "serve.prepare", "serve.prewarm", "serve.restack",
        "serve.compile_dispatch", "serve.dispatch", "serve.d2h",
        "serve.writeback", "serve.quarantine", "serve.drain"}
