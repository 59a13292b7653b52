"""The port's serving slice (``pulsar_timing_gibbsspec_torch/serve``)
against the JAX package's, on the CPU.

Datasets are 2 synthetic pulsars (24-40 TOAs) under ``bench.py``'s CRN
model with 3 modes, padded into one bucket of 3 pulsars (one pad pulsar
per dataset), 12 sweeps a job in chunks of 4.  Classes:

- routing, ladders, overflow hints, migration plans, ``probe_shape`` and
  the padded model's arrays: exact equality with the JAX functions;
- one multiplexed sweep of 3 tenants against ``jax.vmap(
  sharded_sweep_step)`` on the JAX stack with the noise drawn from the
  same keys: x to 1e-5 relative (float32 grid draws land on the same
  grid point, whose float32 value differs by an ULP, as in
  ``test_torch_blocks.py``), b to 1e-5 of its largest entry (the exact
  draw at x one float32 ULP apart);
- padding: a dataset's real rows in a padded sweep equal its unpadded
  sweep's to 1e-12 relative (x) and 1e-10 of the largest entry (b):
  the float64 Gram and factor run at other shapes;
- a stack of one tenant, tenant independence (solo, next to others, in
  another slot, 2 against 4 slots), eviction, the drain, quarantine,
  the retried device error and the tenant_evict crash: bitwise.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.data.simulate import synthetic_array
from pulsar_timing_gibbsspec_torch.runtime import (faults, integrity,
                                                   preemption)
from pulsar_timing_gibbsspec_torch.sampler import blocks
from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays
from pulsar_timing_gibbsspec_torch.serve import (
    BucketOverflow, BucketSpec, BucketTable, Dataset, DatasetShape,
    ProgramCache, SamplerService, SignatureMismatch, bench_dataset,
    plan_migration, probe_shape, stack_models)
from pulsar_timing_gibbsspec_torch.serve import engine
from test_torch_cases import jax_fields, jax_pta, same_field, state, t64

torch.set_num_threads(2)

NITER = 12
NBINS = 3
BUCKET = BucketSpec(3, 48, 24, NBINS)
TABLE = BucketTable([BUCKET])
#: (seed, largest TOA count) of each dataset
SPECS = ((0, 40), (1, 30), (2, 36), (3, 33))


def _psrs(seed, ntoa_max, npsr=2):
    return synthetic_array(npsr=npsr, seed=seed, ntoa_min=24,
                           ntoa_max=ntoa_max)


def _dataset(seed, ntoa_max, npsr=2, **opts):
    if opts:
        base = bench_dataset(_psrs(seed, ntoa_max, npsr), NBINS, NBINS)
        return Dataset(base.psrs, **dict(base.opts, **opts))
    return bench_dataset(_psrs(seed, ntoa_max, npsr), NBINS, NBINS)


_CACHE = ProgramCache()


def _service(root, **kw):
    """A CPU service sharing the module's program cache (a successor
    service reusing its predecessor's programs)."""
    kw.setdefault("cache", _CACHE)
    kw.setdefault("slots", 2)
    kw.setdefault("chunk", 4)
    kw.setdefault("quantum", 100)
    kw.setdefault("device", "cpu")
    return SamplerService(root, TABLE, **kw)


def _run_all(svc, data, order=None):
    order = range(len(data)) if order is None else order
    jobs = {i: svc.submit(data[i], NITER, job_id=f"job{i}", tenant_id=i)
            for i in order}
    rep = svc.run()
    return [jobs[i] for i in sorted(jobs)], rep


def _same_chains(jobs, solo):
    for i, job in enumerate(jobs):
        assert job.state == "done", (i, job.state, job.failure)
        np.testing.assert_array_equal(job.chain, solo[i][0])
        np.testing.assert_array_equal(job.bchain, solo[i][1])


@pytest.fixture(scope="module")
def data():
    return [_dataset(s, n) for s, n in SPECS]


@pytest.fixture(scope="module")
def solo(data, tmp_path_factory):
    """Each dataset alone in a service of 2 slots: its chain, bchain and
    checkpoint directory."""
    base = tmp_path_factory.mktemp("solo")
    out = []
    for i, ds in enumerate(data):
        svc = _service(base / f"s{i}")
        job = svc.submit(ds, NITER, job_id=f"job{i}", tenant_id=i)
        svc.run()
        assert job.state == "done"
        out.append((job.chain.copy(), job.bchain.copy(), job.outdir))
    return out


# -- routing -----------------------------------------------------------------

_SHAPES = [(2, 30, 20, 3), (3, 90, 28, 3), (8, 1000, 60, 3), (2, 41, 24, 3),
           (9, 10, 10, 3), (2, 50, 24, 5), (4, 100, 31, 3), (1, 1, 1, 3)]
_TABLES = [
    [(2, 40, 24, 3)],
    [(4, 100, 30, 3), (2, 40, 24, 3), (8, 1000, 60, 3)],
    [(2, 40, 24, 3), (2, 80, 24, 5)],
]


@pytest.mark.parametrize("table", _TABLES, ids=["one", "three", "two_k"])
@pytest.mark.parametrize("shape", _SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_routing_matches_jax(table, shape):
    """Smallest cover, the typed overflow (nearest bucket and hint) and
    the migration plan equal the JAX functions'."""
    from pulsar_timing_gibbsspec_tpu.serve import buckets as jb

    tp = BucketTable([BucketSpec(*b) for b in table])
    tj = jb.BucketTable([jb.BucketSpec(*b) for b in table])
    sp, sj = DatasetShape(*shape), jb.DatasetShape(*shape)

    def outcome(fn):
        try:
            got = fn()
        except (ValueError, BucketOverflow) as exc:
            return (type(exc).__name__, str(exc),
                    getattr(getattr(exc, "nearest", None), "as_tuple",
                            lambda: None)(),
                    getattr(getattr(exc, "hint", None), "as_tuple",
                            lambda: None)())
        if hasattr(got, "kind"):
            return (got.kind, got.parent_bucket.as_tuple(),
                    got.child_bucket.as_tuple(), got.in_place)
        return got.as_tuple()

    assert outcome(lambda: tp.route(sp)) == outcome(lambda: tj.route(sj))
    for parent in table:
        assert outcome(lambda: plan_migration(tp, BucketSpec(*parent), sp)) \
            == outcome(lambda: jb.plan_migration(tj, jb.BucketSpec(*parent),
                                                 sj))


@pytest.mark.parametrize("modes,pulsars,toas", [
    (10, (8, 46), (128, 1024)), (3, (2, 4), (64, 256)), (5, (1,), (32,))])
def test_ladder_matches_jax(modes, pulsars, toas):
    from pulsar_timing_gibbsspec_tpu.serve.buckets import BucketTable as JT

    got = BucketTable.ladder(modes, pulsars=pulsars, toas=toas)
    ref = JT.ladder(modes, pulsars=pulsars, toas=toas)
    assert [b.as_tuple() for b in got.buckets] == \
        [b.as_tuple() for b in ref.buckets]


def test_probe_shape_matches_jax(data):
    from pulsar_timing_gibbsspec_tpu.serve.buckets import (
        probe_shape as jprobe)

    for ds in data + [_dataset(5, 120, npsr=3)]:
        got = probe_shape(ds)
        ref = jprobe(jax_pta(ds.psrs, NBINS, NBINS))
        assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert all(TABLE.route_pta(ds) == BUCKET for ds in data)
    with pytest.raises(BucketOverflow):
        TABLE.route_pta(_dataset(5, 120, npsr=3))


@pytest.mark.parametrize("pad", [(3, 48, 24), (4, 64, 30), (None, 45, None)])
def test_padded_model_matches_compile_pta(data, pad):
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    ds = data[0]
    P, N, B = pad
    ref = jax_fields(compile_pta(jax_pta(ds.psrs, NBINS, NBINS),
                                 pad_pulsars=P, pad_toas=N, pad_basis=B))
    got = ds.model_arrays(pad_pulsars=P, pad_toas=N, pad_basis=B)
    for name, v in ref.items():
        if name == "components":
            for c, d in zip(v, got[name], strict=True):
                for k in c:
                    same_field(c[k], d[k], f"components.{k}")
        elif name in ("dtype", "cdtype"):
            assert np.dtype(v) == np.dtype(got[name])
        else:
            same_field(v, got[name], name)
    with pytest.raises(ValueError, match="pad_toas"):
        ds.model_arrays(pad_toas=8)
    with pytest.raises(ValueError, match="pad_basis"):
        ds.model_arrays(pad_basis=2)


def _noise(cm, seed):
    gen = torch.Generator().manual_seed(seed)
    return engine.SweepNoise(*[v[None] if i >= 4 else v[:, None]
                               for i, v in enumerate(
                                   engine.row_noise(cm, gen))])


def test_padding_is_exact(data):
    """A dataset's sweep in a padded bucket (pad pulsar, TOA rows and
    basis columns) moves its real coordinates as the unpadded sweep does,
    with the pads' noise unused."""
    ds = data[1]
    cm0 = from_arrays(ds.model_arrays(), device="cpu")
    cm1 = engine.compile_bucket(ds, BucketSpec(3, 64, 32, NBINS), "cpu")
    x = t64(state(cm0, seed=2))[None]
    z = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (cm0.P, cm0.Bmax)))
    b0 = blocks.draw_b_fn_core(cm0, x, z[None])
    b1 = torch.zeros((1, cm1.P, cm1.Bmax), dtype=torch.float64)
    b1[:, :cm0.P, :cm0.Bmax] = b0
    n0 = _noise(cm0, 7)
    n1 = _noise(cm1, 8)
    g_red, z1 = n1.g_red.clone(), n1.z.clone()
    g_red[:, :cm0.P] = n0.g_red
    z1[:, :cm0.P, :cm0.Bmax] = n0.z
    n1 = n1._replace(scale=n0.scale, jpos=n0.jpos, eps=n0.eps, logu=n0.logu,
                     g_red=g_red, rho=n0.rho, z=z1)
    s0, s1 = stack_models([cm0]), stack_models([cm1])
    xa, ba = engine.mux_sweep_core(s0, x, b0, n0)
    xb, bb = engine.mux_sweep_core(s1, x, b1, n1)
    np.testing.assert_allclose(xb.numpy(), xa.numpy(), rtol=1e-12)
    real = bb[:, :cm0.P, :cm0.Bmax]
    assert (real - ba).abs().max() <= 1e-10 * ba.abs().max()


@pytest.mark.parametrize("case", ["toas", "pulsars", "modes", "same"])
def test_signature_mismatch_where_jax_raises(data, case):
    """``adopt_static`` refuses (or takes) the same pairs as the JAX
    function: another padded TOA axis, another real pulsar count, another
    mode count; two datasets of one shape share a program."""
    from pulsar_timing_gibbsspec_tpu.serve import engine as je
    from pulsar_timing_gibbsspec_tpu.serve.buckets import BucketSpec as JB

    a = data[0]
    b, bucket_b = {
        "toas": (data[0], (3, 64, 24, NBINS)),
        "pulsars": (_dataset(4, 40, npsr=3), (3, 48, 24, NBINS)),
        "modes": (bench_dataset(_psrs(0, 40), 4, 4), (3, 48, 24, 4)),
        "same": (data[2], (3, 48, 24, NBINS)),
    }[case]
    bucket_a = (3, 48, 24, NBINS)

    def jax_side():
        ca = je.compile_bucket(jax_pta(a.psrs, NBINS, NBINS), JB(*bucket_a))
        nb = bucket_b[3]
        cb = je.compile_bucket(jax_pta(b.psrs, nb, nb), JB(*bucket_b))
        je.adopt_static(cb, ca)

    def port_side():
        ca = engine.compile_bucket(a, BucketSpec(*bucket_a), "cpu")
        cb = engine.compile_bucket(b, BucketSpec(*bucket_b), "cpu")
        engine.adopt_static(cb, ca)

    raised = []
    for fn, exc in ((jax_side, je.SignatureMismatch),
                    (port_side, SignatureMismatch)):
        try:
            fn()
            raised.append(False)
        except exc:
            raised.append(True)
    assert raised[0] == raised[1] == (case != "same")


# -- the multiplexed sweep ---------------------------------------------------

def _jax_noise(cmj, key):
    """The noise ``jax_backend.sharded_sweep_step`` draws from ``key``:
    the white MH's, the red and rho Gumbels, the b normals."""
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.config import settings as jset
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cdt, fdt = jnp.float64, jnp.float32
    R = jset.rho_grid_size
    k = jr.split(key, 5)
    white = []
    for kk in jr.split(k[0], engine.WHITE_STEPS):
        k1, k2, k3, k4 = jr.split(kk, 4)
        white.append((
            jr.choice(k1, jnp.asarray(jb._SCALES, cdt),
                      p=jnp.asarray(jb._SCALE_P, cdt)),
            jr.randint(k2, (), 0, len(cmj.idx.white)),
            jr.normal(k3, dtype=cdt),
            jnp.log(jr.uniform(k4, dtype=cdt))))
    white = [np.asarray(jnp.stack(v)) for v in zip(*white)]
    return white + [
        np.asarray(jr.gumbel(k[1], (cmj.P, cmj.Kr, R), dtype=fdt)),
        np.asarray(jr.gumbel(k[2], (cmj.K, R), dtype=fdt)),
        np.asarray(jr.normal(k[3], (cmj.P, cmj.Bmax), cdt))]


def test_mux_sweep_matches_jax_vmap(data):
    """One sweep of 3 stacked tenants: the port's ``mux_sweep_core`` on
    the JAX-drawn noise against ``jax.vmap(sharded_sweep_step)`` on the
    JAX ``stack_cms`` of the same models."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb
    from pulsar_timing_gibbsspec_tpu.serve import engine as je
    from pulsar_timing_gibbsspec_tpu.serve.buckets import BucketSpec as JB

    jcache = je.ProgramCache()
    cmjs = [jcache.adopt(JB(*BUCKET.as_tuple()), je.compile_bucket(
        jax_pta(ds.psrs, NBINS, NBINS), JB(*BUCKET.as_tuple())))[0]
        for ds in data[:3]]
    cms = [from_arrays(jax_fields(c), device="cpu") for c in cmjs]
    X = np.stack([state(c, seed=10 + t) for t, c in enumerate(cms)])
    rng = np.random.default_rng(4)
    B = np.stack([blocks.draw_b_fn_core(
        c, t64(X[t])[None], t64(rng.standard_normal((1, c.P, c.Bmax))))[0]
        .numpy() for t, c in enumerate(cms)])
    keys = jnp.stack([jr.PRNGKey(20 + t) for t in range(3)])
    xj, bj = jax.jit(jax.vmap(jb.sharded_sweep_step))(
        je.stack_cms(cmjs), jnp.asarray(X), jnp.asarray(B), keys)
    rows = [_jax_noise(cmjs[0], keys[t]) for t in range(3)]
    cols = [np.stack(v, axis=1 if i < 4 else 0)
            for i, v in enumerate(zip(*rows))]
    noise = engine.SweepNoise(*[torch.as_tensor(c) for c in cols])
    xt, bt = engine.mux_sweep_core(stack_models(cms), t64(X), t64(B), noise)
    xj, bj = np.asarray(xj), np.asarray(bj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-5)
    assert np.abs(bt.numpy() - bj).max() <= 1e-5 * np.abs(bj).max()
    # every block moved something
    assert not np.allclose(xj[:, cms[0].idx.rho], X[:, cms[0].idx.rho])
    assert not np.allclose(xj[:, cms[0].idx.red_rho],
                           X[:, cms[0].idx.red_rho])


def test_stack_of_one_is_bitwise_the_model(data):
    """Every core the sweep runs, on a stack of one tenant, equals the
    same core on the unstacked model bitwise."""
    cm = engine.compile_bucket(data[0], BUCKET, "cpu")
    st = stack_models([cm])
    x = t64(state(cm, seed=3))[None]
    z = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (1, cm.P, cm.Bmax)))
    b = blocks.draw_b_fn_core(cm, x, z)
    assert torch.equal(blocks.draw_b_fn_core(st, x, z), b)
    for fn in (lambda m: m.ndiag_fast(x), lambda m: m.phi(x),
               lambda m: m.red_phi(x), lambda m: m.gw_phi_at_red(x),
               lambda m: m.red_tau(b), lambda m: blocks.residual_sq(m, b),
               lambda m: blocks.lnlike_white_per(
                   m, x, blocks.residual_sq(m, b)),
               lambda m: blocks.tnt_d(m, m.ndiag_fast(x))):
        got, ref = fn(st), fn(cm)
        for g, r in zip(got if isinstance(got, tuple) else (got,),
                        ref if isinstance(ref, tuple) else (ref,)):
            assert torch.equal(g, r)
    n = _noise(cm, 9)
    xa, ba = engine.mux_sweep_core(st, x, b, n)
    xb, bb = engine.mux_sweep_core(cm, x, b, n)
    assert torch.equal(xa, xb) and torch.equal(ba, bb)


# -- tenant independence, eviction, recovery --------------------------------

@pytest.mark.parametrize("layout", ["2_slots_churn", "4_slots_reversed"])
def test_tenants_bitwise_independent(data, solo, tmp_path, layout):
    """A tenant's chain is its solo chain bitwise: next to others with
    fair-share churn at 2 slots, and at 4 slots in another slot."""
    if layout == "2_slots_churn":
        svc = _service(tmp_path / "mux", quantum=2, cache=ProgramCache())
        jobs, rep = _run_all(svc, data[:3])
        assert rep["evictions"] >= 1
        assert rep["warm_hit_rate"] == pytest.approx(2.0 / 3.0)
        assert rep["captures"] == 0         # no graphs on the CPU
    else:
        svc = _service(tmp_path / "wide", slots=4)
        jobs, rep = _run_all(svc, data, order=[3, 2, 1, 0])
    _same_chains(jobs, solo)
    for job in jobs:
        disk = np.load(tmp_path / ("mux" if layout[0] == "2" else "wide")
                       / job.job_id / "chain.npy")
        np.testing.assert_array_equal(disk, job.chain)
    assert "queue_depth" in svc.prometheus()


def test_eviction_midrun_resume(data, solo, tmp_path):
    """A job checkpointed mid-run loads through ``integrity.load_resume``
    and a fresh service readmits it bit-exactly."""
    root = tmp_path / "resume"
    svc = _service(root, save_every=1)
    for i in range(2):
        svc.submit(data[i], NITER, job_id=f"job{i}", tenant_id=i)
    assert svc.step()
    chain, bchain, upto, adapt = integrity.load_resume(root / "job0")
    assert upto == 4 and int(adapt["tenant_id"]) == 0
    np.testing.assert_array_equal(chain, solo[0][0][:4])
    jobs, _ = _run_all(_service(root), data[:2])
    _same_chains(jobs, solo)


@pytest.mark.parametrize("what", ["tenant", "generation"])
def test_resume_refuses_stream_crossing(tmp_path, what):
    from pulsar_timing_gibbsspec_torch.sampler.chains import ChainStore
    from pulsar_timing_gibbsspec_torch.serve.jobs import Job

    store = ChainStore(tmp_path / "jobX", ["p0", "p1"], ["b0"])
    store.save(np.ones((2, 2)), np.ones((2, 1)), 2,
               adapt_state={"x": np.ones(2), "b": np.ones((1, 1)),
                            "tenant_id": np.asarray(7, np.int64),
                            "generation": np.asarray(1, np.int64)})
    job = Job(job_id="jobX", dataset=None, niter=4, tenant_id=7,
              outdir=str(tmp_path / "jobX"), generation=1)
    job.alloc(2, 1)
    if what == "tenant":
        job.tenant_id = 3
    else:
        job.generation = 0
    with pytest.raises(RuntimeError, match=f"{what}|crossing"):
        job.try_resume()
    job.tenant_id, job.generation = 7, 1
    assert job.try_resume()
    assert job.it == 2 and job.chain[:2].all()


def test_tenant_evict_crash_recovery(data, solo, tmp_path):
    """Eviction churn and a crash mid-multiplex: every in-flight job
    resumes from its own verified directory, bitwise."""
    root = tmp_path / "mux"
    faults.clear()
    faults.inject("tenant_evict", point="serve.chunk", at_row=2, times=1)
    faults.inject("crash", point="serve.chunk", at_row=3, times=1)
    svc = _service(root, max_retries=0)
    jobs = [svc.submit(d, NITER, job_id=f"job{i}", tenant_id=i)
            for i, d in enumerate(data[:3])]
    try:
        with pytest.raises(faults.InjectedCrash):
            svc.run()
    finally:
        faults.clear()
    assert svc.report()["evictions"] == 1
    assert [j for j in jobs if 0 < j.it < NITER]
    for job in jobs:
        if job.it > 0:
            assert integrity.verify(root / job.job_id)["ok"]
    jobs2, _ = _run_all(_service(root), data[:3])
    _same_chains(jobs2, solo)


def test_transient_device_error_retried(data, solo, tmp_path):
    faults.clear()
    faults.inject("xla_error", point="serve.chunk", at_row=2, times=1)
    svc = _service(tmp_path / "retry", save_every=1)
    try:
        jobs, rep = _run_all(svc, data[:2])
    finally:
        faults.clear()
    assert rep["service_retries"] == 1
    _same_chains(jobs, solo)


def test_drain_and_fresh_service_resume(data, solo, tmp_path):
    root = tmp_path / "drain"
    preemption.reset()
    try:
        svc = _service(root)
        jobs = [svc.submit(d, NITER, job_id=f"job{i}", tenant_id=i)
                for i, d in enumerate(data[:3])]
        assert svc.step()
        preemption.request_drain(reason="test")
        with pytest.raises(preemption.Preempted) as ei:
            svc.run()
        assert ei.value.verified
        for job in jobs:
            if job.it > 0:
                assert job.state == "queued"
                assert integrity.verify(root / job.job_id)["ok"]
    finally:
        preemption.reset()
    jobs2, _ = _run_all(_service(root), data[:3])
    _same_chains(jobs2, solo)


def test_quarantine_one_row(data, solo, tmp_path):
    """A poisoned tenant quarantines alone: the co-residents and the
    victim, after its replay from its checkpoint, end bitwise."""
    faults.clear()
    faults.inject("poison_rows", tenant=2, at_row=1, times=1)
    svc = _service(tmp_path / "drill", slots=4, save_every=1)
    try:
        jobs, rep = _run_all(svc, data)
    finally:
        faults.clear()
    assert rep["quarantines"] == 1
    (ev,) = rep["quarantine_log"]
    assert ev["tenant_id"] == 2 and ev["chunk"] == 2
    _same_chains(jobs, solo)
    assert jobs[2].quarantines == 1


def test_quarantine_budget_parks(data, solo, tmp_path):
    faults.clear()
    faults.inject("poison_rows", tenant=1, at_row=1, times=10)
    svc = _service(tmp_path / "park", save_every=1, quarantine_max=1)
    try:
        jobs, rep = _run_all(svc, data[:2])
    finally:
        faults.clear()
    assert jobs[0].state == "done"
    np.testing.assert_array_equal(jobs[0].chain, solo[0][0])
    assert jobs[1].state == "quarantined"
    assert "budget exhausted" in jobs[1].failure
    assert rep["quarantines"] == 2
    with pytest.raises(integrity.CheckpointError, match="force.requeue"):
        integrity.load_resume(tmp_path / "park" / "job1")
    chain, _, upto, _ = integrity.load_resume(tmp_path / "park" / "job1",
                                              force_requeue=True)
    assert upto == jobs[1].it > 0
    np.testing.assert_array_equal(chain, solo[1][0][:upto])


# -- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("kw,exc", [
    ({"ensemble": True}, ValueError), ({"pt_ladder": 2}, ValueError),
    ({"mesh": object()}, NotImplementedError),
    ({"placement": [{"slots": 2}]}, NotImplementedError)])
def test_refused_options(tmp_path, kw, exc):
    with pytest.raises(exc, match="ROADMAP|ensemble"):
        _service(tmp_path, **kw)


@pytest.mark.parametrize("kw", [
    {"prewarm": 1}, {"breaker": True}, {"admission": True},
    {"perf": True}], ids=["prewarm", "breaker", "admission", "perf"])
def test_guard_options_accepted(tmp_path, kw):
    """The options the second serving slice brings construct and run a
    job to the solo chain's end (``tests/test_torch_quarantine.py`` holds
    their behaviour against the JAX service)."""
    svc = _service(tmp_path, **kw)
    job = svc.submit(_dataset(0, 40), 4, tenant_id=0)
    rep = svc.run()
    svc.close()
    assert job.state == "done" and np.isfinite(job.chain).all()
    assert ("stage_summary" in rep) == bool(kw.get("perf"))


@pytest.mark.parametrize("method", ["append_job", "evacuate", "split_slice",
                                    "merge_slices"])
def test_refused_methods(tmp_path, method):
    svc = _service(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP A.15"):
        getattr(svc, method)()


@pytest.mark.parametrize("opts", [
    {"red_psd": "powerlaw"}, {"red_psd": "tprocess"}, {"dm_var": True},
    {"orf": "bin_orf"}, {"nanograv": True}],
    ids=["red_powerlaw", "tprocess", "dm_gp", "orf_weights", "ecorr"])
def test_models_the_sweep_does_not_draw_are_refused(tmp_path, opts):
    opts = dict(opts)
    psrs = _psrs(0, 40)
    if opts.pop("nanograv", False):
        psrs[0].flags = {"pta": "NANOGrav"}
    base = bench_dataset(psrs, NBINS, NBINS)
    ds = Dataset(psrs, **dict(base.opts, **opts))
    with pytest.raises(ValueError, match="frozen"):
        _service(tmp_path).submit(ds, NITER)


def test_correlated_orf_is_refused(tmp_path):
    ds = _dataset(0, 40, orf="hd")
    with pytest.raises(NotImplementedError, match="ROADMAP A.15"):
        _service(tmp_path).submit(ds, NITER)


def test_jax_service_leaves_such_parameters_frozen(tmp_path):
    """What the refusal guards: the JAX service samples a red-powerlaw
    model without moving its red hypers."""
    from pulsar_timing_gibbsspec_tpu.serve import BucketSpec as JB
    from pulsar_timing_gibbsspec_tpu.serve import BucketTable as JT
    from pulsar_timing_gibbsspec_tpu.serve import SamplerService as JS

    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    psrs = _psrs(0, 40)
    pta = model_general([Pulsar(**dataclasses.asdict(p)) for p in psrs],
                        tm_svd=True, white_vary=True, common_psd="spectrum",
                        common_components=NBINS, red_var=True,
                        red_psd="powerlaw", red_components=NBINS)
    svc = JS(tmp_path, JT([JB(3, 48, 24, NBINS)]), slots=1, chunk=4)
    job = svc.submit(pta, 4, tenant_id=0)
    svc.run()
    assert job.state == "done"
    names = list(pta.param_names)
    hyp = [j for j, n in enumerate(names)
           if "red_noise_log10_A" in n or "red_noise_gamma" in n]
    assert hyp and np.all(job.chain[:, hyp] == job.chain[0, hyp])
    white = [j for j, n in enumerate(names) if "efac" in n]
    assert not np.all(job.chain[:, white] == job.chain[0, white])


# -- state carried across ---------------------------------------------------

def test_port_job_dir_loads_in_jax(solo):
    from pulsar_timing_gibbsspec_tpu.runtime import integrity as jint

    chain, bchain, upto, adapt = jint.load_resume(solo[0][2])
    assert upto == NITER
    np.testing.assert_array_equal(chain, solo[0][0])
    np.testing.assert_array_equal(bchain, solo[0][1])
    assert int(adapt["tenant_id"]) == 0
    np.testing.assert_array_equal(adapt["x"], solo[0][0][-1])
    assert jint.verify(solo[0][2])["ok"]


def test_jax_job_checkpoint_is_adopted(data, solo, tmp_path):
    """A checkpoint the JAX ``Job`` writes (``adapt.npz`` with ``x``,
    ``b``, ``tenant_id``, ``generation``) is where the port's job goes
    on from: resumed at its row 4, the chain ends as the solo run."""
    from pulsar_timing_gibbsspec_tpu.serve.buckets import BucketSpec as JB
    from pulsar_timing_gibbsspec_tpu.serve.jobs import Job as JJob

    ds = data[0]
    cm = engine.compile_bucket(ds, BUCKET, "cpu")
    out = tmp_path / "job0"
    jjob = JJob(job_id="job0", niter=NITER, tenant_id=0, outdir=str(out),
                pta=types.SimpleNamespace(pulsars=list(cm.pulsars),
                                          param_names=list(cm.param_names)))
    jjob.cm = types.SimpleNamespace(P=cm.P, Bmax=cm.Bmax)
    jjob.bucket = JB(*BUCKET.as_tuple())
    jjob.alloc(cm.nx, cm.P * cm.Bmax)
    jjob.open_store()
    jjob.it = 4
    jjob.chain[:4], jjob.bchain[:4] = solo[0][0][:4], solo[0][1][:4]
    jjob.x = solo[0][0][3]
    jjob.b = solo[0][1][3].reshape(cm.P, cm.Bmax)
    jjob.checkpoint()
    svc = _service(tmp_path)
    job = svc.submit(ds, NITER, job_id="job0", tenant_id=0, outdir=out)
    assert svc.step() and job.it == 8
    svc.run()
    _same_chains([job], solo[:1])
