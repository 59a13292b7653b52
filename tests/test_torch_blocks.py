"""The port's Gibbs blocks against the JAX package's, fed the JAX-drawn
noise.

Each stochastic JAX block is run from a key; the test draws the same
noise from that key exactly as the JAX function does (``jr.split`` ->
``normal``/``uniform``/``gumbel``/``choice``) and hands it to the port's
``*_core`` function.  Tolerance classes, by the arithmetic involved:

- float64 state updates (x, b after exact draws): 1e-8 of the largest
  entry (float64 sums in other orders through conditioned solves);
- b-draw proposals: within 1e-3 proposal standard deviations (the
  whitened difference ``L^T (db / dj)``; the float32 factor's error
  sits in the soft directions, so per-coefficient relative differences
  are no measure), accept decisions equal wherever
  ``|logr - logu| > 1e-3``;
- float32 white-noise MH: states to 1e-5 relative (float32 ``log`` and
  ``pow`` differ in the last bits between the frameworks);
- grid draws: the same grid point (values to 1e-5 relative: the float32
  grids differ by an ULP).
"""

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.ops.kernels import reference
from pulsar_timing_gibbsspec_torch.sampler import blocks
from test_torch_cases import close, cov_noise, models, state, t32, t64

torch.set_num_threads(2)

NSTEPS = 12
MH_STEPS = 4
NEWTON = 3


@pytest.fixture(scope="module")
def case():
    """(cmj, cmt, x, b, u): the small model at a seeded state with b an
    exact conditional draw and u = T b (JAX side's float32 matvec)."""
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models()
    x = state(cmt, seed=5)
    z = np.random.default_rng(6).standard_normal((cmt.P, cmt.Bmax))
    b = blocks.draw_b_fn_core(cmt, t64(x), t64(z)).numpy()
    u = np.asarray(jb.b_matvec(cmj, jnp.asarray(b)))
    return cmj, cmt, x, b, u


def _jit(fn, *args):
    import jax
    import jax.numpy as jnp

    out = jax.jit(fn)(*map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.asarray, out)


def test_grams_match_jax(case):
    """Same N on both sides (the JAX side's float32 ndiag_fast)."""
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = case
    ref = _jit(lambda xx: (cmj.ndiag_fast(xx),
                           jb._gram_operands(cmj, cmj.ndiag_fast(xx), 96),
                           jb.tnt_d(cmj, cmj.ndiag_fast(xx)),
                           jb.tnt_d_seg(cmj, cmj.ndiag_fast(xx)),
                           jb.tnt_d_seg32(cmj, cmj.ndiag_fast(xx))), x)
    Nj, (TNa, Ta), exact, seg, seg32 = ref
    close(cmt.ndiag_fast(t64(x)), Nj, 2e-6)
    N = t32(Nj)
    Ta_t, N_t = blocks._gram_operands(cmt, N, 96)
    close(Ta_t, Ta, 0)
    close(N_t, Nj, 0)
    # the plain Gram's operand, IEEE division: bitwise
    close(reference.gram_operand(Ta_t, N_t), TNa, 0)
    scale = np.sqrt(np.abs(np.diagonal(exact[0], axis1=1, axis2=2)))
    jac = scale[:, :, None] * scale[:, None, :]
    jac = np.where(jac > 0, jac, 1.0)
    nseg, m = TNa.shape[1], TNa.shape[2]
    for fn, (G, d), tol in ((blocks.tnt_d, exact, 8 * 2.0 ** -52),
                            (blocks.tnt_d_seg, seg,
                             4 * np.sqrt(m) * 2.0 ** -23),
                            (blocks.tnt_d_seg32, seg32,
                             4 * np.sqrt(m + nseg) * 2.0 ** -23)):
        Gt, dt = fn(cmt, N)
        assert np.all(np.abs(Gt.numpy() - G) / jac <= tol), fn.__name__
        # d's Jacobi scale: sqrt(G_ii y^T N^-1 y)
        yy = (TNa[..., -1].astype(np.float64) * Ta[..., -1]).sum((1, 2))
        assert np.all(np.abs(dt.numpy() - d)
                      <= tol * scale * np.sqrt(yy)[:, None])


def test_matvec_and_log_densities_match_jax(case):
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = case
    b2 = b * 1.01
    ref = _jit(lambda xx, bb, b2_: (
        jb.b_matvec(cmj, bb), jb.residual_sq(cmj, bb),
        jb._logpi_b_per(cmj, xx, bb, jb.b_matvec(cmj, bb)),
        jb._logpi_b_pair(cmj, xx, bb, b2_, jb.b_matvec(cmj, bb),
                         jb.b_matvec(cmj, b2_))), x, b, b2)
    xt, bt, b2t = t64(x), t64(b), t64(b2)
    ut = blocks.b_matvec(cmt, bt)
    close(ut, ref[0], 0, atol=1e-5 * np.abs(ref[0]).max())
    close(blocks.residual_sq(cmt, bt), ref[1], 0,
          atol=1e-4 * np.abs(ref[1]).max())
    lp = blocks._logpi_b_per(cmt, xt, bt, t32(ref[0]))
    close(lp, ref[2], 1e-5)
    lo, ln = blocks._logpi_b_pair(cmt, xt, bt, b2t, t32(ref[0]),
                                  blocks.b_matvec(cmt, b2t))
    close(lo, ref[3][0], 1e-5)
    close(ln, ref[3][1], 1e-5)


def _mh_noise(cmj, key, dtype):
    import jax.numpy as jnp
    import jax.random as jr

    k1, k2 = jr.split(key)
    z = jr.normal(k1, (cmj.P, cmj.Bmax), dtype)
    logu = jnp.log(jr.uniform(k2, (cmj.P,), jnp.float64))
    return z, logu


@pytest.fixture(scope="module")
def b_draw_ref(case):
    """The JAX steady and refresh b-draws from two keys each, with the
    noise each draws, in one compiled call."""
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = case

    def run(xx, bb, uu):
        out = {}
        for kind, fn, zdt in (("mh", jb.draw_b_mh, jnp.float32),
                              ("refresh", jb.draw_b_refresh, jnp.float64)):
            for s in (7, 8):
                key = jr.PRNGKey(s)
                out[f"{kind}{s}"] = (fn(cmj, xx, bb, uu, key),
                                _mh_noise(cmj, key, zdt))
        return out

    return _jit(run, x, b, u)


@pytest.mark.parametrize("kind", ["mh", "refresh"])
def test_b_draws_match_jax_noise(case, b_draw_ref, kind):
    cmj, cmt, x, b, u = case
    core = blocks.propose_b_mh if kind == "mh" else blocks.propose_b_refresh
    draw = (blocks.draw_b_mh_core if kind == "mh"
            else blocks.draw_b_refresh_core)
    for seed in (7, 8):
        (bj, uj, accj), (z, logu) = b_draw_ref[f"{kind}{seed}"]
        zt = torch.tensor(z)
        bp, up, logr, ok, L, dj = core(cmt, t64(x), t64(b), t32(u), zt)
        bt, ut, acct = draw(cmt, t64(x), t64(b), t32(u), zt, t64(logu))
        decided = np.abs(logr.numpy() - logu) > 1e-3
        assert np.array_equal(acct.numpy()[decided], accj[decided])
        assert acct.numpy()[decided].any()
        # accepted proposals agree in the proposal's own metric: the
        # whitened difference L^T (db / dj), in proposal standard
        # deviations
        both = acct.numpy() & accj
        dv = ((bt - t64(bj)) / dj.double())[..., None]
        w = (L.double().transpose(-1, -2) @ dv)[..., 0].numpy()
        assert np.abs(w[both]).max() <= 1e-3
        rej = ~acct.numpy()
        assert np.array_equal(bt.numpy()[rej], b[rej])


def test_exact_draw_matches_jax_noise(case):
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = case

    def run(xx):
        key = jr.PRNGKey(11)
        return (jb.draw_b_fn(cmj, xx, key),
                jr.normal(key, (cmj.P, cmj.Bmax), cmj.cdtype))

    bj, z = _jit(run, x)
    bt = blocks.draw_b_fn_core(cmt, t64(x), t64(z)).numpy()
    assert np.abs(bt - bj).max() <= 1e-8 * np.abs(bj).max()
    # a pulsar whose draw is not finite keeps its current b (zeros when
    # none is given); the others are unchanged
    zn = z.copy()
    zn[1, 0] = np.nan
    for cur, keep in ((t64(b), b[1]), (None, np.zeros_like(b[1]))):
        bn = blocks.draw_b_fn_core(cmt, t64(x), t64(zn), cur).numpy()
        assert np.array_equal(bn[1], keep)
        assert np.array_equal(bn[[0, 2]], bt[[0, 2]])


def test_white_likelihoods_match_jax(case):
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = case
    r = cmt.y.numpy() - u
    q = x.copy()
    q[cmt.idx.white] += 0.05
    ref = _jit(lambda xx, qq, rr: (
        jb.lnlike_white_per(cmj, xx, rr * rr),
        jb.white_block_ll(cmj, xx, rr, rr * rr)(qq)), x, q, r)
    close(blocks.lnlike_white_per(cmt, t64(x), t32(r * r)), ref[0], 1e-10)
    got = blocks.white_block_ll(cmt, t64(x), t32(r), t32(r * r))(t64(q))
    close(got, ref[1], 0, atol=1e-4)


@pytest.fixture(scope="module")
def white_ref(case):
    """The JAX white block in one compiled call: the Laplace proposal
    (``NEWTON`` Newton steps) and both forms of the full-block MH scan from it,
    with the noise each scan draws."""
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = case
    r = cmt.y.numpy() - u
    W = cmt.white_par_ix.shape[1]

    def run(xx, rr):
        r2 = rr * rr
        xm, L, asq = jb.laplace_newton_chol(
            cmj, xx, lambda q: jb.lnlike_white_per(cmj, q, r2),
            cmj.white_par_ix, cmj.white_nper, newton_iters=NEWTON)
        safe = np.minimum(np.asarray(cmj.white_par_ix), cmj.nx - 1)
        out = {"laplace": (xm, L, asq)}
        for with_mode in (False, True):
            name = "mixed" if with_mode else "walk"
            mode = xm[safe].astype(jnp.float32) if with_mode else None
            asq32 = asq.astype(jnp.float32) if with_mode else None
            key = jr.PRNGKey(3)
            out[name] = (jb.parallel_cov_mh_scan(
                cmj, xx, key, jb.white_block_ll(cmj, xx, rr, r2),
                cmj.white_par_ix, cmj.white_nper, L.astype(jnp.float32),
                NSTEPS, mode=mode, asqrt=asq32),
                cov_noise(cmj, key, W, NSTEPS, with_mode), mode, asq32)
        return out

    return r, _jit(run, x, r)


@pytest.mark.parametrize("with_mode", [False, True])
def test_parallel_cov_mh_scan_matches_jax_noise(case, white_ref, with_mode):
    """The white block's full-block MH: random walk (warmup) and the
    mixed independence/random-walk kernel (steady), with the Laplace
    factors of the JAX side fed to both."""
    cmj, cmt, x, b, u = case
    r, ref = white_ref
    _, L, _ = ref["laplace"]
    (xj, recj), (scale, z, logu, coin), mode, asq = ref[
        "mixed" if with_mode else "walk"]
    rt = t32(r)
    xt, rect = blocks.parallel_cov_mh_scan_core(
        cmt, t64(x), blocks.white_block_ll(cmt, t64(x), rt, rt * rt),
        cmt.white_par_ix, cmt.white_nper, t32(L), torch.tensor(scale),
        torch.tensor(z), torch.tensor(logu),
        coin=torch.tensor(coin) if with_mode else None,
        mode=t32(mode) if with_mode else None,
        asqrt=t32(asq) if with_mode else None)
    close(rect, recj, 1e-5)
    close(xt, xj, 1e-5)
    assert not np.array_equal(xj, x)              # the chain moved


def test_laplace_matches_jax(case, white_ref):
    cmj, cmt, x, b, u = case
    r, ref = white_ref
    xm, L, asq = ref["laplace"]
    r2t = t32(r * r)
    xt, Lt, asqt = blocks.laplace_newton_chol(
        cmt, t64(x), lambda q: blocks.lnlike_white_per(cmt, q, r2t),
        cmt.white_par_ix, cmt.white_nper, newton_iters=NEWTON)
    close(xt, xm, 1e-8)
    # eigenvector signs are free: compare the covariance and precision
    close(Lt @ Lt.transpose(-1, -2), L @ np.swapaxes(L, -1, -2), 1e-6,
          atol=1e-12)
    close(asqt @ asqt.transpose(-1, -2), asq @ np.swapaxes(asq, -1, -2),
          1e-6, atol=1e-6)


def test_block_eigh_matches_jax_with_a_nan_block(case):
    """Finite blocks: the eigenvalues of ``jnp.linalg.eigh`` to 1e-12 of
    the largest; a block with a NaN entry: NaN eigenvalues on both
    sides.  (``case`` has compiled a JAX model, which turns on JAX's
    float64.)"""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    M = rng.standard_normal((4, 6, 6))
    A = M @ np.swapaxes(M, -1, -2) + np.diag(10.0 ** np.arange(6))
    A[2, 1, 3] = A[2, 3, 1] = np.nan
    ej = np.asarray(jnp.linalg.eigh(jnp.asarray(A))[0])
    et, Vt = blocks._block_eigh(t64(A))
    fin = [0, 1, 3]
    close(et[fin], ej[fin], 0, atol=1e-12 * np.abs(ej[fin]).max())
    assert np.isnan(et[2]).all() and np.isnan(Vt[2]).all()
    assert not np.isfinite(ej[2]).all()
    assert torch.isfinite(et[fin]).all() and torch.isfinite(Vt[fin]).all()


@pytest.fixture(scope="module")
def nan_block_ref(case):
    """The JAX Laplace proposal with pulsar 1's conditional made NaN, and
    the random-walk scan from its factors with the noise it draws."""
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = case
    r = cmt.y.numpy() - u
    poison = np.ones(cmt.P)
    poison[1] = np.nan

    def run(xx, rr):
        r2 = rr * rr
        xm, L, asq = jb.laplace_newton_chol(
            cmj, xx, lambda q: jb.lnlike_white_per(cmj, q, r2) * poison,
            cmj.white_par_ix, cmj.white_nper, newton_iters=NEWTON)
        key = jr.PRNGKey(4)
        W = cmj.white_par_ix.shape[1]
        return (xm, L, jb.parallel_cov_mh_scan(
            cmj, xx, key, jb.white_block_ll(cmj, xx, rr, r2),
            cmj.white_par_ix, cmj.white_nper, L.astype(jnp.float32),
            NSTEPS), cov_noise(cmj, key, W, NSTEPS, False))

    return r, poison, _jit(run, x, r)


def test_nan_laplace_block_rejects_like_jax(case, nan_block_ref):
    """A pulsar whose curvature block is non-finite: its Newton steps
    and every MH proposal made from its factor are rejected on both
    sides; the other pulsars agree as in the finite case."""
    cmj, cmt, x, b, u = case
    r, poison, (xm, L, (xj, recj), (scale, z, logu, _)) = nan_block_ref
    r2t = t32(r * r)
    pt = t64(poison)
    xt, Lt, _ = blocks.laplace_newton_chol(
        cmt, t64(x), lambda q: blocks.lnlike_white_per(cmt, q, r2t) * pt,
        cmt.white_par_ix, cmt.white_nper, newton_iters=NEWTON)
    close(xt, xm, 1e-8)
    n1 = int(cmt.white_nper[1])
    ix1 = cmt.white_par_ix[1][:n1].numpy()
    close(xt[ix1], x[ix1], 0)                  # no Newton step taken
    fin = [0, 2]
    close(Lt[fin] @ Lt[fin].transpose(-1, -2),
          L[fin] @ np.swapaxes(L[fin], -1, -2), 1e-6, atol=1e-12)
    assert not np.isfinite(L[1, :n1, :n1]).any()
    assert not torch.isfinite(Lt[1, :n1, :n1]).any()
    rt = t32(r)
    xs, rec = blocks.parallel_cov_mh_scan_core(
        cmt, t64(x), blocks.white_block_ll(cmt, t64(x), rt, rt * rt),
        cmt.white_par_ix, cmt.white_nper, Lt.to(torch.float32),
        torch.tensor(scale), torch.tensor(z), torch.tensor(logu))
    close(xs, xj, 1e-5)
    close(rec, recj, 1e-5)
    close(xs[ix1], x[ix1], 0)                  # every proposal rejected
    assert not np.array_equal(xj, x)


def test_mh_scan_matches_jax_noise(case):
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = case
    ind = np.asarray(cmt.idx.white)
    r2 = (cmt.y.numpy() - u) ** 2
    cdt = jnp.float64

    def run(xx, rr2):
        ll = lambda q: jnp.sum(jb.lnlike_white_per(cmj, q, rr2))  # noqa
        key = jr.PRNGKey(4)
        out = jb.mh_scan(cmj, xx, key, ll, ind, MH_STEPS)
        noise = []
        for k in jr.split(key, MH_STEPS):
            k1, k2, k3, k4 = jr.split(k, 4)
            noise.append((
                jr.choice(k1, jnp.asarray(jb._SCALES, cdt),
                          p=jnp.asarray(jb._SCALE_P, cdt)),
                jr.randint(k2, (), 0, len(ind)),
                jr.normal(k3, dtype=cdt),
                jnp.log(jr.uniform(k4, dtype=cdt))))
        return out, [jnp.stack(v) for v in zip(*noise)]

    (xj, recj), (scale, jpos, eps, logu) = _jit(run, x, r2)
    r2t = t32(r2)
    xt, rect = blocks.mh_scan_core(
        cmt, t64(x), lambda q: blocks.lnlike_white_per(cmt, q, r2t).sum(-1),
        ind, t64(scale), torch.tensor(jpos, dtype=torch.int64),
        t64(eps), t64(logu))
    close(rect, recj, 1e-10)
    close(xt, xj, 1e-10)


def test_rho_and_red_grid_draws_match_jax_noise(case):
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.config import settings
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = case
    R = settings.rho_grid_size

    def run(xx, bb):
        k1, k2 = jr.PRNGKey(5), jr.PRNGKey(6)
        return (jb.rho_update(cmj, xx, bb, k1),
                jr.gumbel(k1, (cmj.K, R), dtype=jnp.float32),
                jb.red_conditional_update(cmj, xx, bb, k2),
                jr.gumbel(k2, (cmj.P, cmj.Kr, R), dtype=jnp.float32))

    xr, g1, xd, g2 = _jit(run, x, b)
    got = blocks.rho_update_core(cmt, t64(x), t64(b), torch.tensor(g1))
    close(got, xr, 1e-5)
    assert not np.allclose(xr[cmt.idx.rho], x[cmt.idx.rho])
    got = blocks.red_conditional_update_core(cmt, t64(x), t64(b),
                                             torch.tensor(g2))
    close(got, xd, 1e-5)
    assert not np.allclose(xd[cmt.idx.red_rho], x[cmt.idx.red_rho])


def test_rho_scale_moves_match_jax_noise(case):
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = case

    def run(xx, bb, uu):
        key = jr.PRNGKey(9)
        eps, lu = [], []
        for k in jr.split(key, cmj.K):
            kz, ka = jr.split(k)
            eps.append(jr.normal(kz, dtype=cmj.cdtype))
            lu.append(jnp.log(jr.uniform(ka, dtype=cmj.cdtype)))
        return (jb.rho_scale_moves(cmj, xx, bb, uu, key),
                jnp.stack(eps), jnp.stack(lu))

    (xj, bj, uj), eps, logu = _jit(run, x, b, u)
    xt, bt, ut = blocks.rho_scale_moves_core(
        cmt, t64(x), t64(b), t32(u), t64(eps), t64(logu))
    close(xt, xj, 1e-10)
    close(bt, bj, 1e-10)
    close(ut, uj, 1e-5, atol=1e-6 * np.abs(uj).max())
    assert not np.array_equal(xj, x)


def test_batched_chains_equal_single_chains(case):
    """The chains axis is a batch: each chain of a batched block call
    equals the block run on that chain alone."""
    _, cmt, x, b, u = case
    C = 2
    xs = t64(np.stack([x, state(cmt, seed=8)]))
    bs, us = t64(np.stack([b, b * 0.9])), t32(np.stack([u, u * 0.9]))
    rng = np.random.default_rng(12)
    g = torch.tensor(rng.gumbel(size=(C, cmt.K, 1000)),
                        dtype=torch.float32)
    gr = torch.tensor(rng.gumbel(size=(C, cmt.P, cmt.Kr, 1000)),
                         dtype=torch.float32)
    eps, lu = t64(rng.standard_normal((C, cmt.K))), t64(
        np.log(rng.uniform(size=(C, cmt.K))))
    z = t32(rng.standard_normal((C, cmt.P, cmt.Bmax)))
    logu = t64(np.log(rng.uniform(size=(C, cmt.P))))
    batched = (blocks.rho_update_core(cmt, xs, bs, g),
               blocks.red_conditional_update_core(cmt, xs, bs, gr),
               blocks.rho_scale_moves_core(cmt, xs, bs, us, eps, lu),
               blocks.draw_b_mh_core(cmt, xs, bs, us, z, logu))
    for c in range(C):
        single = (
            blocks.rho_update_core(cmt, xs[c], bs[c], g[c]),
            blocks.red_conditional_update_core(cmt, xs[c], bs[c], gr[c]),
            blocks.rho_scale_moves_core(cmt, xs[c], bs[c], us[c], eps[c],
                                        lu[c]),
            blocks.draw_b_mh_core(cmt, xs[c], bs[c], us[c], z[c], logu[c]))
        for one, many in zip(single, batched):
            for a, m in zip(one if isinstance(one, tuple) else (one,),
                            many if isinstance(many, tuple) else (many,)):
                close(a, m[c], 1e-6, atol=1e-30)


def test_noise_wrappers_draw_the_stated_laws():
    gen = torch.Generator().manual_seed(0)
    s = blocks._scale_choice(gen, (40000,), torch.float64, "cpu").numpy()
    freq = [np.mean(s == v) for v in blocks._SCALES]
    np.testing.assert_allclose(freq, blocks._SCALE_P, atol=0.01)
    g = blocks._gumbel(gen, (40000,), torch.float32, "cpu").numpy()
    assert abs(g.mean() - 0.5772) < 0.03 and np.isfinite(g).all()
    u = blocks._uniform(gen, (1000,), torch.float32, "cpu")
    assert (u > 0).all() and (u < 1).all()
