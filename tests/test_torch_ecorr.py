"""The single-pulsar pieces of the port against the JAX package:
the model with basis ECORR, the ECORR blocks, the inverse-CDF rho draw
and the plain kernel versions at the J1713+0747 snapshot's width.

Inputs: the recorded J1713+0747 snapshot (720 TOAs, 4 backends, 508
ECORR columns) at 10 frequency bins (Bmax = 633), for deterministic
pieces only; and a small synthetic pulsar flagged NANOGrav (JSYN02: 120
TOAs, 3 backends, Bmax = 125 with 107 ECORR columns; JSYN01, Bmax = 95,
on the narrow kernels' side of the boundary).  Tolerance classes:

- model arrays: exact equality, field by field;
- float64 quantities (phi, the ECORR conditional, the inverse-CDF
  draw, the Laplace mode): 1e-12 relative (the frameworks' ``pow`` /
  ``log`` / ``expm1`` differ in the last bits), the Laplace factors
  1e-6 (eigenvector signs are free, so compared as covariances);
- float32 quantities (the relative ECORR likelihood, the MH scan):
  1e-4 absolute on O(100) sums, 1e-5 relative on states;
- plain kernel versions against the JAX package's XLA reference twins
  (bitwise equal to its Pallas kernels in interpret mode,
  tests/test_kernels.py): Gram within 2 eps_f64 (widening) or 4
  sqrt(m + nseg) eps_f32 of the Jacobi scale, the float64 factor chain
  within 1e-8 of each output's largest entry (float64 sums in other
  orders through a system conditioned by ECORR and timing columns).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.models.build import model_arrays
from pulsar_timing_gibbsspec_torch.ops import kernels
from pulsar_timing_gibbsspec_torch.sampler import blocks
from test_torch_cases import (close, cov_noise, jax_fields, jax_single_pta,
                              nanograv_psr, same_field, single_models,
                              small_psrs, snapshot_psrs, state, t32, t64)

torch.set_num_threads(2)

EPS32, EPS64 = 2.0 ** -23, 2.0 ** -52
NSTEPS = 12
NEWTON = 3


def _model_case(name):
    """(JAX pta, compile_pta options, port model_arrays options,
    port pulsars) of a named case."""
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    if name == "J1713":
        jp, tp = snapshot_psrs()
        return (jax_single_pta(jp, 10, tm_svd=True), {},
                dict(tm_svd=True, common_components=10, red_var=False),
                [tp])
    if name in ("JSYN02", "JSYN01"):
        p = nanograv_psr(2 if name == "JSYN02" else 1)
        return (jax_single_pta(p), {},
                dict(common_components=4, red_var=False), [p])
    # an array: ECORR beside intrinsic red noise, one pulsar without ECORR
    psrs = small_psrs()
    for p in psrs[1:]:
        p.flags = {"pta": "NANOGrav"}
    pta = model_general([Pulsar(**dataclasses.asdict(p)) for p in psrs],
                        tm_svd=True, white_vary=True, common_psd="spectrum",
                        common_components=4, red_var=True,
                        red_psd="spectrum", red_components=3)
    return (pta, dict(pad_pulsars=4),
            dict(tm_svd=True, common_components=4, red_var=True,
                 red_components=3, pad_pulsars=4), psrs)


@pytest.mark.parametrize("name", ["J1713", "JSYN02", "JSYN01", "array"])
def test_model_matches_compile_pta(name):
    """(a) The port's model arrays equal ``compile_pta``'s field by
    field: ``T``, ``ec_cols``, ``ec_ix``, ``ecorr_par_ix``,
    ``ecorr_nper``, the ``"ecorr"`` component, parameter order, widths."""
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    pta, copt, mopt, psrs = _model_case(name)
    ref = jax_fields(compile_pta(pta, **copt))
    got = model_arrays(psrs, **mopt)
    assert set(ref) <= set(got)
    for key, v in ref.items():
        if key == "components":
            assert [c["kind"] for c in v] == [c["kind"] for c in got[key]]
            for c, d in zip(v, got[key]):
                for k in c:
                    same_field(c[k], d[k], f"components.{c['kind']}.{k}")
        elif key in ("dtype", "cdtype"):
            assert np.dtype(v) == np.dtype(got[key])
        else:
            same_field(v, got[key], key)
    assert got["param_names"] == tuple(pta.param_names)
    if name == "J1713":
        assert (got["Bmax"], got["nx"]) == (633, 22)
        assert got["ec_cols"].shape == (1, 508)
    if name == "JSYN02":
        assert (got["Bmax"], got["nx"], got["ec_cols"].shape[1]) == (
            125, 13, 107)


def test_model_general_surface():
    """The port's ``model_general`` takes README's Quick-start options
    and refuses what the port does not sample: the single-alpha
    t-process, a split red process, the log-spaced frequency grid, and a
    red PSD with shape hypers (the first and last the JAX package
    refuses too)."""
    from pulsar_timing_gibbsspec_torch import model_general

    p = nanograv_psr()
    cm = model_general([p], red_var=False, white_vary=True,
                       common_psd="spectrum", common_components=4,
                       device="cpu")
    assert cm.ec_cols.shape == (1, 107) and cm.red_kind == ""
    wide = model_general([p], red_var=False, white_vary=True,
                         common_psd="spectrum", common_components=4,
                         is_wideband=True, device="cpu")
    assert wide.ec_cols.shape[1] == 0 and len(wide.idx.ecorr) == 0
    for kw in (dict(red_var=True, red_psd="tprocess_adapt"),
               dict(red_var=True, red_psd="spectrum", red_select="band"),
               dict(orf="crn,crn"),
               dict(red_var=True, red_psd="broken_powerlaw")):
        opts = dict(red_var=False, white_vary=True, common_psd="spectrum")
        opts.update(kw)
        with pytest.raises(NotImplementedError):
            model_general([p], device="cpu", **opts)


@pytest.fixture(scope="module")
def case():
    """(cmj, cmt, x, b): the JSYN02 Quick-start model at a seeded state
    with 2 chains, ``b`` drawn with the ECORR columns at their prior
    scale (so the ECORR terms are O(1))."""
    cmj, cmt = single_models()
    x = state(cmt, C=2, seed=5)
    rng = np.random.default_rng(6)
    b = rng.standard_normal((2, cmt.P, cmt.Bmax)) * 1e-7
    ec = cmt.ec_cols.numpy()[0]
    e = x[:, cmt.ec_ix.numpy()[0]]
    b[:, 0, ec] = rng.standard_normal(e.shape) * 10.0 ** e
    return cmj, cmt, x, b


def _vjit(fn, *args):
    import jax
    import jax.numpy as jnp

    out = jax.jit(jax.vmap(fn))(*map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.asarray, out)


def test_phi_and_ecorr_likelihoods_match_jax(case):
    """(b) ``phi`` (ECORR columns carry ``10^(2 log10_ecorr)``),
    ``lnlike_ecorr_per`` (compute dtype) and ``ecorr_ll_rel`` (storage
    dtype)."""
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b = case
    q = x.copy()
    q[:, cmt.idx.ecorr] += np.array([0.1, -0.07, 0.05])
    ref = _vjit(lambda xx, bb, qq: (
        cmj.phi(xx), cmj.phi(xx, dtype=jnp.float32),
        jb.lnlike_ecorr_per(cmj, xx, bb), jb.ecorr_ll_rel(cmj, xx, bb)(qq),
        jb.ecorr_block_ll(cmj, xx, bb, None)(qq)), x, b, q)
    xt, bt, qt = t64(x), t64(b), t64(q)
    close(cmt.phi(xt), ref[0], 1e-12)
    close(cmt.phi(xt, dtype=torch.float32), ref[1], 2e-6)
    ec = cmt.ec_cols.numpy()[0]
    e = x[:, cmt.ec_ix.numpy()[0]]
    close(cmt.phi(xt)[:, 0, ec], 10.0 ** (2.0 * e), 1e-12)
    close(blocks.lnlike_ecorr_per(cmt, xt, bt), ref[2], 1e-12)
    close(blocks.ecorr_ll_rel(cmt, xt, bt)(qt), ref[3], 0, atol=1e-4)
    close(blocks.ecorr_block_ll(cmt, xt, bt, None)(qt), ref[4], 0,
          atol=1e-4)
    assert np.abs(ref[3]).max() > 1e-2       # the move changes the target


@pytest.mark.parametrize("zero", ["none", "one_bin", "all"])
def test_inverse_cdf_rho_draw_matches_jax(case, zero):
    """(c) The single-pulsar inverse-CDF draw given the JAX-drawn
    uniforms, with ``tau = 0`` (clamped) on no bin, one bin, every bin;
    the grid draw refuses a single pulsar without red noise."""
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b = case
    b = b.copy()
    gs, gc = cmt.gw_sin_ix.numpy()[0], cmt.gw_cos_ix.numpy()[0]
    if zero == "one_bin":
        b[:, 0, [gs[1], gc[1]]] = 0.0
    elif zero == "all":
        b[:] = 0.0
    keys = jr.split(jr.PRNGKey(9), 2)

    def run(xx, bb, kk):
        k1, = jr.split(kk, 1)
        return (jb.rho_update(cmj, xx, bb, kk),
                jr.uniform(k1, (cmj.K,), dtype=jnp.float64))

    xr, u = _vjit(run, x, b, keys)
    got = blocks.rho_invcdf_core(cmt, t64(x), t64(b), t64(u))
    close(got, xr, 1e-12)
    rho = got[:, cmt.rho_ix_x].numpy()
    assert np.all((rho >= -10.0) & (rho <= -4.0))
    assert not np.allclose(rho, x[:, cmt.rho_ix_x.numpy()])
    with pytest.raises(ValueError):
        blocks.rho_update_core(cmt, t64(x), t64(b), torch.zeros(
            2, cmt.K, 1000))
    gen = torch.Generator().manual_seed(0)
    out = blocks.rho_update(cmt, t64(x), t64(b), gen)
    assert torch.isfinite(out).all()


def test_ecorr_laplace_and_mh_scan_match_jax(case):
    """(d) The ECORR block's Laplace factor (warmup form, no Newton steps,
    and the adaptation's, with Newton steps) and one ECORR
    ``parallel_cov_mh_scan`` with the mixed independence / random-walk
    kernel, given the JAX-drawn noise."""
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b = case
    x0, b0 = x[0], b[0]
    W = cmt.ecorr_par_ix.shape[1]
    safe = np.minimum(np.asarray(cmj.ecorr_par_ix), cmj.nx - 1)

    def run(xx, bb):
        curv = lambda q: jb.lnlike_ecorr_per(cmj, q, bb)  # noqa: E731
        out = {}
        for it in (0, NEWTON):
            out[it] = jb.laplace_newton_chol(
                cmj, xx, curv, cmj.ecorr_par_ix, cmj.ecorr_nper,
                newton_iters=it)
        xm, L, asq = out[NEWTON]
        mode = xm[safe].astype(jnp.float32)
        key = jr.PRNGKey(3)
        scan = jb.parallel_cov_mh_scan(
            cmj, xm, key, jb.ecorr_block_ll(cmj, xm, bb, None),
            cmj.ecorr_par_ix, cmj.ecorr_nper, L.astype(jnp.float32), NSTEPS,
            mode=mode, asqrt=asq.astype(jnp.float32))
        return out, scan, cov_noise(cmj, key, W, NSTEPS, True), mode

    import jax

    ref = jax.tree_util.tree_map(np.asarray, jax.jit(run)(
        jnp.asarray(x0), jnp.asarray(b0)))
    lap, (xj, recj), (scale, z, logu, coin), mode = ref
    bt = t64(b0)
    for it in (0, NEWTON):
        xm, L, asq = lap[it]
        xt, Lt, asqt = blocks.laplace_newton_chol(
            cmt, t64(x0), lambda q: blocks.lnlike_ecorr_per(cmt, q, bt),
            cmt.ecorr_par_ix, cmt.ecorr_nper, newton_iters=it)
        close(xt, xm, 1e-12)
        close(Lt @ Lt.transpose(-1, -2), L @ np.swapaxes(L, -1, -2), 1e-6,
              atol=1e-14)
        close(asqt @ asqt.transpose(-1, -2),
              asq @ np.swapaxes(asq, -1, -2), 1e-6, atol=1e-6)
    xm, L, asq = lap[NEWTON]
    assert not np.allclose(xm, x0)                # the Newton steps moved
    xt, rect = blocks.parallel_cov_mh_scan_core(
        cmt, t64(xm), blocks.ecorr_block_ll(cmt, t64(xm), bt, None),
        cmt.ecorr_par_ix, cmt.ecorr_nper, t32(L), torch.tensor(scale),
        torch.tensor(z), torch.tensor(logu), coin=torch.tensor(coin),
        mode=t32(mode), asqrt=t32(asq))
    close(rect, recj, 1e-5)
    close(xt, xj, 1e-5)
    assert not np.array_equal(xj, xm)             # the chain moved


@pytest.fixture(scope="module")
def snapshot_system():
    """The J1713+0747 snapshot at 10 bins (Bmax = 633): both models, a
    seeded state of 2 chains and its Gram operands on both sides."""
    import jax
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    jp, _ = snapshot_psrs()
    cmj = compile_pta(jax_single_pta(jp, 10, tm_svd=True))
    cmt = from_arrays(jax_fields(cmj), device="cpu")
    x = state(cmt, C=2, seed=8)
    Nv = cmt.ndiag_fast(t64(x))
    Ta, N = blocks._gram_operands(cmt, Nv, 96)
    TNa_j, Ta_j = jax.jit(jax.vmap(lambda n: jb._gram_operands(cmj, n, 96)))(
        jnp.asarray(Nv.numpy()))
    return cmj, cmt, x, Ta, N.reshape(-1, N.shape[-1]), TNa_j, Ta_j


@pytest.mark.parametrize("form", ["f32", "f32_dot_f64_reduce", "widen_f64"])
def test_plain_gram_at_snapshot_width_matches_jax(snapshot_system, form):
    """(e) The port's plain Gram at B1 = 634 against the JAX package's
    Gram (XLA reference twin) on its own ``TNa = Ta / N``."""
    import jax
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.ops import kernels as jk

    cmj, cmt, x, Ta, N, TNa_j, Ta_j = snapshot_system
    assert Ta.shape[-1] == 634 > kernels.GRAM_MAX_B1
    odt = torch.float32 if form == "f32" else torch.float64
    widen = form == "widen_f64"
    got = kernels.gram_accumulate(Ta, N, out_dtype=odt, widen=widen)
    TNa_j = TNa_j.reshape((-1,) + TNa_j.shape[2:])
    Ta_j = Ta_j.reshape((-1,) + Ta_j.shape[2:])
    ref = np.asarray(jax.jit(lambda a, b: jk.gram_accumulate(
        a, b, out_dtype=jnp.dtype(str(odt).split(".")[1]), widen=widen,
        tier="xla"))(TNa_j, Ta_j))
    assert got.dtype == odt and got.shape == ref.shape == (2, 634, 634)
    dg = np.sqrt(np.diagonal(ref.astype(np.float64), axis1=1, axis2=2))
    scale = dg[:, :, None] * dg[:, None, :]
    err = (np.abs(got.numpy().astype(np.float64) - ref)
           / np.where(scale > 0, scale, 1.0))
    nseg, m = Ta.shape[1], Ta.shape[2]
    tol = 2 * EPS64 if widen else 4 * np.sqrt(m + nseg) * EPS32
    assert err.max() <= tol, (form, err.max(), tol)


def test_plain_factor_at_snapshot_width_matches_jax(snapshot_system):
    """(e) The port's plain factor chain on one float64 system of order
    633 (the snapshot's b-draw system) against the JAX package's (XLA
    reference twin)."""
    import jax
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.ops import kernels as jk

    cmj, cmt, x, Ta, N, *_ = snapshot_system
    xt = t64(x[:1])
    TNT, d = blocks.tnt_d(cmt, cmt.ndiag_fast(xt))
    Sig = (TNT + torch.diag_embed(1.0 / cmt.phi(xt)))[0]
    d = d[0]
    assert Sig.shape == (1, 633, 633) and 633 > kernels.CHOL_MAX_N
    z = t64(np.random.default_rng(2).standard_normal((1, 633)))
    got = kernels.chol_solve_sample(Sig, d, z, ridge=4e-6)
    ref = jax.jit(lambda S, dd, zz: jk.chol_solve_sample(
        S, dd, zz, ridge=4e-6, tier="xla"))(
            *(jnp.asarray(t.numpy()) for t in (Sig, d, z)))
    for name, g, r in zip(("L", "Li", "dj", "mean", "bp"), got, ref):
        r = np.asarray(r)
        assert np.isfinite(g.numpy()).all(), name
        assert np.abs(g.numpy() - r).max() <= 1e-8 * np.abs(r).max(), name
