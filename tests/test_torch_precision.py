"""Float64 storage (``PTGIBBS_PRECISION=f64``), float32 compute
(``PTGIBBS_COMPUTE=f32``), the Gram segment lengths and
``PTGIBBS_JOINT_MIXED`` on the port, against the JAX package.

The JAX ``compile_pta`` reads ``settings.precision`` and
``settings.compute_precision`` when it is called, so the JAX side's
setting is patched on its ``settings`` object; the port reads the
environment when a model is built, so its side's is patched there.
Tolerance classes:

- the model's arrays: bitwise (values, dtypes, shapes);
- Grams: float64 operands within ``4 sqrt(m + nseg)`` float64 ULPs of
  the Jacobi scale ``sqrt(G_ii G_jj)`` (float64 sums in other orders);
  float32 operands as in ``test_torch_blocks.py``;
- b-draws and the sweep under float64 storage: float64 state to 1e-8 of
  the largest entry, steady proposals (a float64 factor) to 1e-6
  proposal standard deviations, refresh proposals (the two-float factor,
  float32 class) as under float32 compute;
  under float32 compute (float32 factors of a system of condition
  ~1e4): the accept decisions where ``|logr - logu| > 1e-2``, proposals
  to 0.1 proposal standard deviations, exact draws to 2e-2 of the
  largest entry, the sweep's x to 1e-4 relative;
- whole chains: per-bin medians within 5 combined standard errors.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.config import SettingsError
from pulsar_timing_gibbsspec_torch.models.build import crn_spectrum_arrays
from pulsar_timing_gibbsspec_torch.sampler import blocks
from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays
from pulsar_timing_gibbsspec_torch.serve import engine
from test_torch_cases import (jax_compiled, jax_fields, medians_agree,
                              same_field, small_psrs, state)

torch.set_num_threads(2)

#: (storage, compute) of each setting under test
SETTINGS = {"f64": ("f64", "f64"), "f32_compute": ("f32", "f32")}
EPS64 = 2.0 ** -52
EPS32 = 2.0 ** -23


@contextlib.contextmanager
def jax_settings(**kw):
    """The JAX ``settings`` with ``kw`` set (restored after)."""
    from pulsar_timing_gibbsspec_tpu.config import settings as js

    with pytest.MonkeyPatch.context() as mp:
        for k, v in kw.items():
            mp.setattr(js, k, v)
        yield js


@contextlib.contextmanager
def port_env(**env):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        yield


def _models(setting, psrs=None):
    """``(jax_cm, port_cm)`` of the small model under ``setting``, the
    port's carried across by ``from_arrays``."""
    prec, comp = SETTINGS[setting]
    with jax_settings(precision=prec, compute_precision=comp):
        cmj = jax_compiled(psrs or small_psrs())
    return cmj, from_arrays(jax_fields(cmj), device="cpu")


@pytest.fixture(scope="module", params=sorted(SETTINGS))
def case(request):
    """(setting, cmj, cmt, x, b, u) at a seeded state, b an exact draw,
    u = T b in the storage dtype."""
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = _models(request.param)
    x = state(cmt, seed=5)
    z = np.random.default_rng(6).standard_normal((cmt.P, cmt.Bmax))
    b = blocks.draw_b_fn_core(cmt, _t(x, cmt.cdtype),
                              _t(z, cmt.cdtype)).numpy()
    u = np.asarray(jb.b_matvec(cmj, jnp.asarray(b)))
    return request.param, cmj, cmt, x, b, u


def _t(a, dtype):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _jit(fn, *args):
    import jax
    import jax.numpy as jnp

    out = jax.jit(fn)(*map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.asarray, out)


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_model_arrays_equal_compile_pta(setting):
    """``model_arrays`` under the environment's precisions equals the
    JAX ``compile_pta`` fields under the same settings, bitwise."""
    prec, comp = SETTINGS[setting]
    psrs = small_psrs()
    with jax_settings(precision=prec, compute_precision=comp):
        ref = jax_fields(jax_compiled(psrs))
    with port_env(PTGIBBS_PRECISION=prec, PTGIBBS_COMPUTE=comp):
        got = crn_spectrum_arrays(psrs, 4, 4)
    assert np.dtype(got["dtype"]) == np.dtype(ref["dtype"])
    assert np.dtype(got["cdtype"]) == np.dtype(ref["cdtype"])
    for name, v in ref.items():
        if name == "components":
            for c, d in zip(v, got[name], strict=True):
                for k in c:
                    same_field(c[k], d[k], f"components.{k}")
        elif name not in ("dtype", "cdtype"):
            same_field(v, got[name], name)


@pytest.mark.parametrize("prec,comp,dt,cdt", [
    ("f32", "f64", torch.float32, torch.float64),
    ("f64", "f64", torch.float64, torch.float64),
    ("f64", "f32", torch.float64, torch.float64),
    ("f32", "f32", torch.float32, torch.float32)])
def test_from_arrays_keeps_the_fields_dtypes(prec, comp, dt, cdt):
    """The JAX mapping (float32 compute is the storage dtype), taken from
    the fields and not from the environment, which names another; the
    segment lengths come from the environment."""
    with jax_settings(precision=prec, compute_precision=comp):
        fields = jax_fields(jax_compiled(small_psrs()))
    other = "f32" if prec == "f64" else "f64"
    with port_env(PTGIBBS_PRECISION=other, PTGIBBS_GRAM_SEG="48",
                  PTGIBBS_GRAM_SEG_EXACT="200"):
        cm = from_arrays(fields, device="cpu")
    assert (cm.dtype, cm.cdtype) == (dt, cdt)
    assert cm.T.dtype == cm.y.dtype == cm.sigma2.dtype == cm.pb.dtype == dt
    assert (cm.gram_seg_len, cm.gram_seg_len_exact) == (48, 200)
    with pytest.raises(ValueError, match="float32 or float64"):
        from_arrays(dict(fields, dtype=np.float16), device="cpu")


# -- the Gram ----------------------------------------------------------------

@pytest.mark.parametrize("setting,seg,seg_exact", [
    ("f64", 96, 96), ("f32", 48, 48), ("f32", 200, 200),
    ("f64", 48, 200)])
def test_grams_match_jax(setting, seg, seg_exact):
    """``tnt_d``/``tnt_d_seg``/``tnt_d_seg32`` at the settings' segment
    lengths against the JAX functions at the same settings, on the JAX
    side's N."""
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    prec = setting
    with jax_settings(precision=prec, gram_seg_len=seg,
                      gram_seg_len_exact=seg_exact):
        cmj = jax_compiled(small_psrs())
        with port_env(PTGIBBS_GRAM_SEG=str(seg),
                      PTGIBBS_GRAM_SEG_EXACT=str(seg_exact)):
            cmt = from_arrays(jax_fields(cmj), device="cpu")
        x = state(cmt, seed=5)
        Nj, exact, seg_r, seg32 = _jit(lambda xx: (
            cmj.ndiag_fast(xx), jb.tnt_d(cmj, cmj.ndiag_fast(xx)),
            jb.tnt_d_seg(cmj, cmj.ndiag_fast(xx)),
            jb.tnt_d_seg32(cmj, cmj.ndiag_fast(xx))), x)
    N = torch.as_tensor(Nj)
    assert N.dtype == cmt.dtype
    scale = np.sqrt(np.abs(np.diagonal(exact[0], axis1=1, axis2=2)))
    jac = scale[:, :, None] * scale[:, None, :]
    jac = np.where(jac > 0, jac, 1.0)
    f64 = prec == "f64"
    for fn, (G, d), sl in ((blocks.tnt_d, exact, seg_exact),
                           (blocks.tnt_d_seg, seg_r, seg),
                           (blocks.tnt_d_seg32, seg32, seg)):
        Ta, _ = blocks._gram_operands(cmt, N, sl)
        nseg, m = Ta.shape[1], Ta.shape[2]
        if f64:
            tol = 4 * np.sqrt(m + nseg) * EPS64
        elif fn is blocks.tnt_d:
            tol = 8 * EPS64
        elif fn is blocks.tnt_d_seg:
            tol = 4 * np.sqrt(m) * EPS32
        else:
            tol = 4 * np.sqrt(m + nseg) * EPS32
        Gt, dt = fn(cmt, N)
        assert Gt.dtype == torch.as_tensor(G).dtype, fn.__name__
        err = np.abs(Gt.numpy().astype(np.float64) - G) / jac
        assert err.max() <= tol, (fn.__name__, err.max() / tol)
        assert np.all(np.abs(dt.numpy() - d) <= tol * np.abs(d).max() * 8)


def test_gram_dtypes_refused():
    """A float64 operand with a float32 output raises, on either
    route."""
    from pulsar_timing_gibbsspec_torch.ops import kernels

    Ta = torch.zeros(1, 1, 4, 3, dtype=torch.float64)
    with pytest.raises(TypeError, match="float64 operands"):
        kernels.gram_accumulate(Ta, torch.ones(1, 4, dtype=torch.float64),
                                out_dtype=torch.float32)


# -- b-draws -----------------------------------------------------------------

def _mh_noise(cmj, key, zdt):
    import jax.numpy as jnp
    import jax.random as jr

    k1, k2 = jr.split(key)
    return (jr.normal(k1, (cmj.P, cmj.Bmax), zdt),
            jnp.log(jr.uniform(k2, (cmj.P,), cmj.cdtype)))


@pytest.mark.parametrize("kind", ["mh", "refresh"])
def test_b_draws_match_jax_noise(case, kind):
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    setting, cmj, cmt, x, b, u = case
    fn = jb.draw_b_mh if kind == "mh" else jb.draw_b_refresh
    zdt = cmj.dtype if kind == "mh" else cmj.cdtype
    ref = _jit(lambda xx, bb, uu: [
        (fn(cmj, xx, bb, uu, jr.PRNGKey(s)),
         _mh_noise(cmj, jr.PRNGKey(s), zdt)) for s in (7, 8)], x, b, u)
    core = blocks.propose_b_mh if kind == "mh" else blocks.propose_b_refresh
    draw = (blocks.draw_b_mh_core if kind == "mh"
            else blocks.draw_b_refresh_core)
    cdt, dt = cmt.cdtype, cmt.dtype
    # float64 storage: the steady proposal is a float64 factor; the
    # refresh proposal's two-float factor keeps its float32 class
    tight = setting == "f64" and kind == "mh"
    for (bj, uj, accj), (z, logu) in ref:
        zt = torch.tensor(z)
        args = (cmt, _t(x, cdt), _t(b, cdt), _t(u, dt), zt)
        bp, up, logr, ok, L, dj = core(*args)
        bt, ut, acct = draw(*args, _t(logu, cdt))
        assert bt.dtype == cdt and ut.dtype == dt
        decided = np.abs(logr.numpy() - logu) > (1e-6 if tight else 1e-2)
        assert np.array_equal(acct.numpy()[decided], accj[decided])
        assert acct.numpy()[decided].any()
        both = acct.numpy() & accj
        dv = ((bt - _t(bj, cdt)) / dj.to(cdt)).double()[..., None]
        w = (L.double().transpose(-1, -2) @ dv)[..., 0].numpy()
        assert np.abs(w[both]).max() <= (1e-6 if tight else 0.1)
        rej = ~acct.numpy()
        assert np.array_equal(bt.numpy()[rej], b[rej])


def test_exact_draw_matches_jax_noise(case):
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    setting, cmj, cmt, x, b, u = case
    bj, z = _jit(lambda xx: (
        jb.draw_b_fn(cmj, xx, jr.PRNGKey(11)),
        jr.normal(jr.PRNGKey(11), (cmj.P, cmj.Bmax), cmj.cdtype)), x)
    bt = blocks.draw_b_fn_core(cmt, _t(x, cmt.cdtype), torch.tensor(z))
    assert bt.dtype == cmt.cdtype
    tol = 1e-8 if setting == "f64" else 2e-2
    assert np.abs(bt.numpy() - bj).max() <= tol * np.abs(bj).max()


def _jax_sweep_noise(cmj, key):
    """The noise ``jax_backend.sharded_sweep_step`` draws from ``key``,
    in the model's dtypes (``test_torch_serve.py``'s, dtype-aware)."""
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.config import settings as js
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cdt, fdt, R = cmj.cdtype, cmj.dtype, js.rho_grid_size
    k = jr.split(key, 5)
    white = []
    for kk in jr.split(k[0], engine.WHITE_STEPS):
        k1, k2, k3, k4 = jr.split(kk, 4)
        white.append((
            jr.choice(k1, jnp.asarray(jb._SCALES, cdt),
                      p=jnp.asarray(jb._SCALE_P, cdt)),
            jr.randint(k2, (), 0, len(cmj.idx.white)),
            jr.normal(k3, dtype=cdt), jnp.log(jr.uniform(k4, dtype=cdt))))
    white = [jnp.stack(v)[:, None] for v in zip(*white)]
    return white + [jr.gumbel(k[1], (1, cmj.P, cmj.Kr, R), dtype=fdt),
                    jr.gumbel(k[2], (1, cmj.K, R), dtype=fdt),
                    jr.normal(k[3], (1, cmj.P, cmj.Bmax), cdt)]


def test_sweep_matches_jax_noise(case):
    """One whole sweep (white MH, red and common rho grids, exact b):
    the port's ``mux_sweep_core`` on a stack of one tenant against the
    JAX ``sharded_sweep_step`` with the noise drawn from its key."""
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    setting, cmj, cmt, x, b, u = case
    key = jr.PRNGKey(21)
    (xj, bj), noise = _jit(lambda xx, bb: (
        jb.sharded_sweep_step(cmj, xx, bb, key),
        _jax_sweep_noise(cmj, key)), x, b)
    cdt = cmt.cdtype
    xt, bt = engine.mux_sweep_core(
        engine.stack_models([cmt]), _t(x, cdt)[None], _t(b, cdt)[None],
        engine.SweepNoise(*map(torch.tensor, noise)))
    assert xt.dtype == bt.dtype == cdt
    f64 = setting == "f64"
    np.testing.assert_allclose(xt[0].numpy(), xj, rtol=1e-12 if f64 else 1e-4)
    tol = 1e-8 if f64 else 2e-2
    assert np.abs(bt[0].numpy() - bj).max() <= tol * np.abs(bj).max()
    assert not np.allclose(xj[cmt.idx.rho], x[cmt.idx.rho])


# -- joint_mixed -------------------------------------------------------------

def test_joint_mixed_from_the_environment():
    """``PTGIBBS_JOINT_MIXED=0`` turns the two-float factors of the HD
    joint draw off where no caller says (the block's default and a
    driver built then), as the JAX ``settings.joint_mixed`` does."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_torch import PTABlockGibbs
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb
    from test_torch_hd import hd_state, models as hd_models, rel

    cmj, cmt = hd_models()
    x = hd_state(cmt, seed=2)[:1]
    n = cmj.P * cmj.Bmax + 2 * cmj.K * cmj.P
    key = jr.PRNGKey(12)
    for flag, env in ((True, "1"), (False, "0")):
        with jax_settings(joint_mixed=flag):
            bj = np.asarray(jax.jit(lambda xx: jb.draw_b_joint_structured(
                cmj, xx, key, exact=False))(jnp.asarray(x[0])))
        z = np.asarray(jr.normal(key, (n,), dtype=cmj.cdtype))
        with port_env(PTGIBBS_JOINT_MIXED=env):
            assert blocks.joint_factor_cache(
                cmt, torch.tensor(x)).mixed is flag
            bt, ok = blocks.draw_b_joint_structured_core(
                cmt, torch.tensor(x), torch.tensor(z)[None])
            assert PTABlockGibbs(cmt, device="cpu").driver.joint_mixed \
                is flag
        assert bool(ok.all()) and rel(bt[0], bj) < 1e-9, flag


def test_bad_environment_refused_at_build(monkeypatch):
    monkeypatch.setenv("PTGIBBS_PRECISION", "F64")
    with pytest.raises(SettingsError, match="PTGIBBS_PRECISION"):
        crn_spectrum_arrays(small_psrs(), 4, 4)
    monkeypatch.setenv("PTGIBBS_PRECISION", "f64")
    monkeypatch.setenv("PTGIBBS_GRAM_SEG", "0")
    with pytest.raises(SettingsError, match="PTGIBBS_GRAM_SEG=0"):
        from_arrays(crn_spectrum_arrays(small_psrs(), 4, 4), device="cpu")


# -- whole chains and the service --------------------------------------------

def test_chain_under_float64_storage(tmp_path_factory):
    """The port's ``PTABlockGibbs`` under ``PTGIBBS_PRECISION=f64``
    against the JAX facade under ``precision="f64"``: 3 pulsars, 4
    chains, common log10_rho medians per bin within 5 combined standard
    errors; the record stays float32 while the carry is float64."""
    import pulsar_timing_gibbsspec_torch as ptt
    import pulsar_timing_gibbsspec_tpu.sampler.gibbs as jgibbs
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    psrs = small_psrs()
    C, warm, niter = 4, 5, 101
    opts = dict(tm_svd=True, white_vary=True, common_psd="spectrum",
                common_components=4, red_var=True, red_psd="spectrum",
                red_components=4)
    jp = [Pulsar(**dataclasses.asdict(p)) for p in psrs]
    pta = model_general(jp, **opts)
    x0 = pta.initial_sample(np.random.default_rng(0))
    run = dict(nchains=C, seed=0, warmup_sweeps=warm, white_adapt_iters=100)
    with jax_settings(precision="f64"):
        jg = jgibbs.PTABlockGibbs(pta, backend="jax", progress=False,
                                  chunk_size=niter - warm - 1, **run)
        jchain = jg.sample(x0, outdir=str(tmp_path_factory.mktemp("jax")),
                           niter=niter)
    with port_env(PTGIBBS_PRECISION="f64"):
        cm = ptt.model_general(psrs, device="cpu", **opts)
    assert cm.dtype == cm.T.dtype == torch.float64
    tg = ptt.PTABlockGibbs(cm, device="cpu", **run)
    tchain = tg.sample(x0, outdir=str(tmp_path_factory.mktemp("torch")),
                       niter=niter)
    assert tg.driver.b.dtype == torch.float64
    assert tg.driver.rdtype == torch.float32
    assert np.isfinite(tchain).all()
    cols = cm.rho_ix_x.numpy()
    mt = medians_agree(jchain, tchain, warm + 1, cols,
                       [cm.param_names[j] for j in cols])
    assert np.all((mt > -10) & (mt < -4))


def test_multiplexed_chunk_under_float64_storage(tmp_path):
    """Two tenants multiplexed in one chunk under float64 storage: each
    tenant's chain is bitwise its chain alone."""
    from pulsar_timing_gibbsspec_torch.data.simulate import synthetic_array
    from pulsar_timing_gibbsspec_torch.serve import (BucketSpec,
                                                     BucketTable,
                                                     SamplerService,
                                                     bench_dataset)

    table = BucketTable([BucketSpec(3, 48, 24, 3)])
    data = [bench_dataset(synthetic_array(npsr=2, seed=s, ntoa_min=24,
                                          ntoa_max=n), 3, 3)
            for s, n in ((0, 40), (1, 30))]
    kw = dict(slots=2, chunk=4, quantum=100, device="cpu")

    def run(root, which):
        svc = SamplerService(root, table, **kw)
        jobs = [svc.submit(data[i], 8, job_id=f"job{i}", tenant_id=i)
                for i in which]
        svc.run()
        assert all(j.state == "done" for j in jobs)
        return {i: (j.chain, j.bchain) for i, j in zip(which, jobs)}

    with port_env(PTGIBBS_PRECISION="f64"):
        both = run(tmp_path / "mux", (0, 1))
        solo = {**run(tmp_path / "s0", (0,)), **run(tmp_path / "s1", (1,))}
        cm = engine.compile_bucket(data[0], table.buckets[0], "cpu")
    assert cm.dtype == torch.float64
    for i in (0, 1):
        np.testing.assert_array_equal(both[i][0], solo[i][0])
        np.testing.assert_array_equal(both[i][1], solo[i][1])
        assert np.isfinite(both[i][0]).all()
