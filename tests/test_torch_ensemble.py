"""The ensemble stage (``sampler/ensemble.py``) and the tempered blocks
against the JAX package's, fed the JAX-drawn noise, and the stage in the
port's driver.

Tolerance classes, by the arithmetic involved:

- the stretch move and the tempering swap's state updates are float64
  throughout: 1e-12 relative, accept masks equal;
- the swap energy is a float32 sum over every TOA in both packages, in
  different orders: 1e-6 relative.  The swap itself is held to 1e-12
  when fed the JAX energies;
- the ASIS redraw chooses points of a float32 grid whose two
  frameworks' values differ by an ULP (``test_torch_blocks.py``): fed
  the JAX grid, the grid choices are equal and b agrees to 1e-12
  relative, u (float32, ``u + dnew t``) to its rounding, 1e-7 of its
  largest entry, and x's float32 ``log10`` of the chosen point to two
  float32 ULPs (2^-22 relative);
  on its own grid the choices are equal;
- the tempered blocks keep the classes of ``test_torch_blocks.py``.
"""

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.sampler import blocks, ensemble
from pulsar_timing_gibbsspec_torch.sampler.compiled import (
    ens_state_from_arrays)
from test_torch_cases import (close, cov_noise, jax_pta, models, small_psrs,
                              state, t32, t64)

torch.set_num_threads(2)

C, T = 8, 2
BETA = 0.6
NSTEPS = 12


def _jit(fn, *args):
    import jax
    import jax.numpy as jnp

    out = jax.jit(fn)(*map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def case():
    """(cmj, cmt, x, b, u): the small model at 8 seeded chain states, b an
    exact conditional draw per chain and u = T b (the JAX float32
    matvec)."""
    import jax
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models()
    x = state(cmt, C=C, seed=5)
    z = np.random.default_rng(6).standard_normal((C, cmt.P, cmt.Bmax))
    b = blocks.draw_b_fn_core(cmt, t64(x), t64(z)).numpy()
    u = np.asarray(jax.vmap(lambda bb: jb.b_matvec(cmj, bb))(
        jnp.asarray(b)))
    return cmj, cmt, x, b, u


def _stretch_noise(key, W, G, dtype):
    """The noise JAX ``stretch_halves`` draws from ``key``: partner
    offsets, stretch and accept uniforms of each half."""
    import jax.random as jr

    h = W // 2
    out = []
    for kh in jr.split(key):
        kp, kz, ka = jr.split(kh, 3)
        out.append((jr.randint(kp, (h, G), 0, W - h),
                    jr.uniform(kz, (h, G), dtype=dtype),
                    jr.uniform(ka, (h, G), dtype=dtype)))
    return tuple(np.stack([np.asarray(o[i]) for o in out])
                 for i in range(3))


def _asis_gumbels(keys, K, R, dtype):
    """The Gumbels JAX ``asis_rho_redraw`` draws from per-chain keys."""
    import jax
    import jax.random as jr

    def one(key):
        return jax.numpy.stack([jr.gumbel(jr.split(k, 1)[0], (R,), dtype)
                                for k in jr.split(key, K)])

    return jax.vmap(one)(keys)


def _jspec(T_):
    from pulsar_timing_gibbsspec_tpu.sampler import ensemble as jens

    return jens.EnsembleSpec(n_temps=T_)


def _tspec(T_):
    return ensemble.EnsembleSpec(n_temps=T_)


def test_stretch_halves_matches_jax(case):
    """A Gaussian ensemble of 6 walkers in 3 groups of dimension 4
    (``case`` has compiled a JAX model, which turns on JAX's
    float64)."""
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import ensemble as jens

    coords = np.random.default_rng(3).standard_normal((6, 3, 4))

    def lp(c, lo):
        return -0.5 * (c * c).sum(-1)

    key = jr.PRNGKey(21)
    got_j, acc_j = jens.stretch_halves(lp, jnp.asarray(coords), key)
    j_off, zu, ua = _stretch_noise(key, 6, 3, jnp.float64)
    got, acc = ensemble.stretch_halves_core(
        lp, t64(coords), torch.tensor(j_off, dtype=torch.int64), t64(zu),
        t64(ua))
    close(got, np.asarray(got_j), 1e-12)
    close(acc, np.asarray(acc_j), 0)
    assert 0 < float(acc.sum()) < 6 * 3


@pytest.mark.parametrize("T_", [1, T])
def test_stretch_rho_move_matches_jax(case, T_):
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import ensemble as jens

    cmj, cmt, x, b, u = case
    key = jr.PRNGKey(22)
    xj, nj = _jit(lambda xx, bb: jens.stretch_rho_move(
        cmj, _jspec(T_), xx, bb, key), x, b)
    noise = _stretch_noise(key, C // T_, T_, jnp.float64)
    xt, nt = ensemble.stretch_rho_move_core(
        cmt, _tspec(T_), t64(x), t64(b),
        torch.tensor(noise[0], dtype=torch.int64), t64(noise[1]),
        t64(noise[2]))
    close(nt, nj, 0)
    close(xt, xj, 1e-12)
    assert nj.sum() > 0 and not np.array_equal(xj, x)


def _jax_grid(cmj):
    import math

    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.config import settings

    return np.asarray(10.0 ** jnp.linspace(
        math.log10(cmj.rhomin), math.log10(cmj.rhomax),
        settings.rho_grid_size, dtype=cmj.dtype))


@pytest.fixture(scope="module")
def asis_ref(case):
    """The JAX ASIS redraw of every chain, untempered and at BETA, with
    the Gumbels it draws."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.config import settings
    from pulsar_timing_gibbsspec_tpu.sampler import ensemble as jens

    cmj, cmt, x, b, u = case
    keys = jr.split(jr.PRNGKey(23), C)

    def run(xx, bb, uu):
        plain = jax.vmap(lambda a, c, d, k: jens.asis_rho_redraw(
            cmj, a, c, d, k))(xx, bb, uu, keys)
        hot = jax.vmap(lambda a, c, d, k: jens.asis_rho_redraw(
            cmj, a, c, d, k, beta=jnp.asarray(BETA)))(xx, bb, uu, keys)
        return plain, hot, _asis_gumbels(keys, cmj.K,
                                         settings.rho_grid_size, cmj.dtype)

    return _jit(run, x, b, u)


def _choices(cm, xs, grid):
    """Grid indices of the common rho values in ``xs`` (C, nx)."""
    r = 10.0 ** (2.0 * np.asarray(xs)[:, cm.rho_ix_x.numpy()])
    return np.abs(np.log(r[..., None]) - np.log(grid)).argmin(-1)


@pytest.mark.parametrize("tempered", [False, True])
def test_asis_redraw_matches_jax(case, asis_ref, monkeypatch, tempered):
    cmj, cmt, x, b, u = case
    plain, hot, gum = asis_ref
    xj, bj, uj = hot if tempered else plain
    beta = torch.full((C,), BETA, dtype=torch.float64) if tempered else None
    args = (cmt, t64(x), t64(b), t32(u), torch.tensor(gum), beta)
    grid_j = _jax_grid(cmj)
    # on its own grid: the same grid points chosen
    xo = ensemble.asis_rho_redraw_core(*args)[0]
    assert np.array_equal(_choices(cmt, xo, grid_j),
                          _choices(cmt, xj, grid_j))
    # on the JAX grid: the arithmetic to float64 rounding
    monkeypatch.setattr(blocks, "_rho_grid",
                        lambda cm, lo, hi: torch.tensor(grid_j))
    xt, bt, ut = ensemble.asis_rho_redraw_core(*args)
    rix = cmt.rho_ix_x.numpy()
    close(bt, bj, 1e-12)
    close(ut, uj, 0, atol=1e-7 * np.abs(uj).max())
    close(xt[:, rix], xj[:, rix], 2.0 ** -22)
    other = np.setdiff1d(np.arange(cmt.nx), rix)
    close(xt[:, other], xj[:, other], 0)
    assert not np.array_equal(xj[:, rix], x[:, rix])


def _jax_energy(cmj, x, u):
    """The JAX stage's swap energy (the expression of its ``pt_swap``)."""
    import jax
    import jax.numpy as jnp

    fdt = cmj.dtype
    toam = jnp.asarray(cmj.toa_mask, fdt)
    Nf = jnp.where(toam > 0, jax.vmap(cmj.ndiag_fast)(x).astype(fdt), 1.0)
    r = jnp.asarray(cmj.y, fdt)[None] - u
    return (-0.5 * jnp.sum(jnp.where(toam > 0, r * r / Nf + jnp.log(Nf),
                                     jnp.zeros((), fdt)),
                           axis=(1, 2))).astype(cmj.cdtype)


@pytest.mark.parametrize("T_, t", [(2, 6), (4, 7), (4, 8)])
def test_pt_swap_matches_jax(case, T_, t):
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import ensemble as jens

    cmj, cmt, x, b, u = case
    llt = ensemble.swap_energy(cmt, t64(x), t32(u))
    # a ladder spaced so that both accepted and refused swaps occur:
    # beta_r - beta_{r+1} ~ exp(lsp) against the energies' spread
    dE = np.abs(np.diff(llt.numpy())).mean()
    es = {k: np.asarray(v) for k, v in jens.init_ens_state(
        _jspec(T_), jnp.float64).items()}
    es["lsp"] = np.log(np.full(T_ - 1, 1.0 / dE))
    es["m"] = np.asarray(7.0)
    key = jr.PRNGKey(24)
    ref = _jit(lambda xx, bb, uu, *e: (
        jens.pt_swap(cmj, _jspec(T_), xx, bb, uu,
                     dict(zip(sorted(es), e)), key, t),
        _jax_energy(cmj, xx, uu),
        jr.uniform(jr.split(key, 1)[0], (C // T_, T_), jnp.float64)),
        x, b, u, *(es[k] for k in sorted(es)))
    (xj, bj, uj, esj), llj, un = ref
    est = ens_state_from_arrays(es, "cpu")
    close(llt, llj, 1e-6)
    xt, bt, ut, est2 = ensemble.pt_swap_core(
        _tspec(T_), t64(x), t64(b), t32(u), est, t64(llj), t64(un), t)
    close(xt, xj, 0)
    close(bt, bj, 0)
    close(ut, uj, 0)
    for k in es:
        close(est2[k], esj[k], 1e-12)
    moved = (xj != x).any(1)
    assert 0 < moved.sum() < C and esj["swap_acc"].sum() > 0
    # the wrapper's energies: the same swaps
    xw = ensemble.pt_swap_core(_tspec(T_), t64(x), t64(b), t32(u), est,
                               llt, t64(un), t)[0]
    close(xw, xj, 0)


def test_ensemble_stage_matches_jax(case, monkeypatch):
    """ASIS (tempered), stretch and a tempering swap after one sweep,
    each fed its JAX-drawn noise, on the JAX rho grid."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.config import settings
    from pulsar_timing_gibbsspec_tpu.sampler import ensemble as jens

    cmj, cmt, x, b, u = case
    spec_j = _jspec(T)
    es = {k: np.asarray(v) for k, v in jens.init_ens_state(
        spec_j, jnp.float64).items()}
    kt = jr.PRNGKey(25)
    t = 9
    keys = jax.vmap(lambda c: jr.fold_in(jr.fold_in(kt, C + 1), c))(
        jnp.arange(C))

    def run(xx, bb, uu, *e):
        (xo, bo, uo), eo = jens.ensemble_stage(
            cmj, spec_j, (xx, bb, uu), dict(zip(sorted(es), e)), kt, t)
        return ((xo, bo, uo), eo,
                _asis_gumbels(keys, cmj.K, settings.rho_grid_size,
                              cmj.dtype),
                jr.uniform(jr.split(jr.fold_in(kt, C + 3), 1)[0],
                           (C // T, T), jnp.float64))

    (xj, bj, uj), esj, gum, un = _jit(
        run, x, b, u, *(es[k] for k in sorted(es)))
    st = _stretch_noise(jr.fold_in(kt, C + 2), C // T, T, jnp.float64)
    monkeypatch.setattr(blocks, "_rho_grid",
                        lambda cm, lo, hi: torch.tensor(_jax_grid(cmj)))
    xt, bt, ut, est = ensemble.ensemble_stage_core(
        cmt, _tspec(T), t64(x), t64(b), t32(u),
        ens_state_from_arrays(es, "cpu"), t, gumbel=torch.tensor(gum),
        stretch=(torch.tensor(st[0], dtype=torch.int64), t64(st[1]),
                 t64(st[2])), un=t64(un))
    close(est["stretch_acc"], esj["stretch_acc"], 0)
    close(est["swap_acc"], esj["swap_acc"], 0)
    close(bt, bj, 1e-12)
    close(ut, uj, 0, atol=1e-7 * np.abs(uj).max())
    close(xt, xj, 2.0 ** -22)
    for k in ("lsp", "m", "swap_try", "stretch_try"):
        close(est[k], esj[k], 1e-6)
    assert not np.array_equal(xj, x)


def test_stage_wrapper_draws_what_the_drivers_blocks_draw(case):
    """``ensemble_stage`` from a generator seeded as the driver seeds
    sweep ``t`` equals the driver's stage blocks after that re-seed: the
    same noise in the same order, the same x, b, u and ensemble state."""
    from pulsar_timing_gibbsspec_torch.sampler.driver import (
        TorchGibbsDriver, stream_seed)

    _, cmt, x, b, u = case
    drv = TorchGibbsDriver(cmt, nchains=C, seed=4, ensemble=True,
                           pt_ladder=T)
    es0 = {k: v.clone() for k, v in drv.ens_state.items()}
    for t in (7, 8):
        for k, v in es0.items():
            drv.ens_state[k].copy_(v)
        drv._reseed(t)
        got = (t64(x), t64(b), t32(u))
        for name in drv.stage_blocks(t):
            got = drv.block(name, *got)
        gen = torch.Generator().manual_seed(stream_seed(4, t))
        want = ensemble.ensemble_stage(cmt, drv.ens, t64(x), t64(b), t32(u),
                                       dict(es0), gen, t)
        for g_, w_ in zip(got, want[:3]):
            assert torch.equal(g_, w_)
        for k, v in want[3].items():
            assert torch.equal(drv.ens_state[k], v), k
    assert drv.stage_blocks(7)[-1] == "pt_swap_odd"


def test_ensemble_summary_and_ladder_match_jax(case):
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.sampler import ensemble as jens

    rng = np.random.default_rng(4)
    es = {"lsp": rng.normal(size=3), "m": np.asarray(12.0),
          "swap_acc": rng.integers(0, 9, 3).astype(float),
          "swap_try": np.full(3, 24.0),
          "stretch_acc": rng.integers(0, 40, 4).astype(float),
          "stretch_try": np.asarray(48.0)}
    assert (ensemble.ensemble_summary(_tspec(4), es)
            == jens.ensemble_summary(_jspec(4), es))
    close(ensemble.betas_from_lsp(t64(es["lsp"])),
          np.asarray(jens.betas_from_lsp(jnp.asarray(es["lsp"]))), 1e-14)
    est = ens_state_from_arrays(es, "cpu")
    close(ensemble.chain_betas(_tspec(4), est, 12),
          np.asarray(jens.chain_betas(_jspec(4), es, 12)), 1e-14)
    init_t = ensemble.init_ens_state(_tspec(3))
    init_j = jens.init_ens_state(_jspec(3), jnp.float64)
    for k in init_j:
        close(init_t[k], np.asarray(init_j[k]), 0)


@pytest.mark.parametrize("nchains, T_, stretch, match", [
    (8, 0, True, "must be >= 1"),
    (9, 2, True, "not a multiple"),
    (6, 2, True, "even number"),
    (4, 4, True, "even number"),
    (6, 3, False, None),
])
def test_validate_ensemble_errors(nchains, T_, stretch, match):
    """The port's errors are the JAX function's."""
    import dataclasses

    from pulsar_timing_gibbsspec_tpu.sampler import ensemble as jens

    spec_t = dataclasses.replace(_tspec(1), n_temps=T_, stretch=stretch)
    spec_j = dataclasses.replace(_jspec(1), n_temps=T_, stretch=stretch)
    if match is None:
        ensemble.validate_ensemble(spec_t, nchains)
        jens.validate_ensemble(spec_j, nchains)
        return
    with pytest.raises(ValueError, match=match) as et:
        ensemble.validate_ensemble(spec_t, nchains)
    with pytest.raises(ValueError) as ej:
        jens.validate_ensemble(spec_j, nchains)
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the tempered blocks


@pytest.fixture(scope="module")
def one(case):
    """One chain of the case (the JAX blocks are single-chain)."""
    cmj, cmt, x, b, u = case
    return cmj, cmt, x[0], b[0], u[0]


def test_tempered_white_mh_matches_jax(one):
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = one
    r = cmt.y.numpy() - u
    W = cmt.white_par_ix.shape[1]
    L = np.tile(0.05 * np.eye(W, dtype=np.float32), (cmt.P, 1, 1))
    key = jr.PRNGKey(26)

    def run(xx, rr):
        ll = jb.white_block_ll(cmj, xx, rr, rr * rr)
        return (jb.parallel_cov_mh_scan(
            cmj, xx, key, lambda q: ll(q) * jnp.asarray(BETA), cmj.white_par_ix,
            cmj.white_nper, jnp.asarray(L), NSTEPS),
            cov_noise(cmj, key, W, NSTEPS, False))

    (xj, recj), (scale, z, logu, _) = _jit(run, x, r)
    rt = t32(r)
    ll = blocks.tempered_ll(blocks.white_block_ll(cmt, t64(x), rt, rt * rt),
                            torch.tensor(BETA, dtype=torch.float64))
    xt, rect = blocks.parallel_cov_mh_scan_core(
        cmt, t64(x), ll, cmt.white_par_ix, cmt.white_nper, t32(L),
        torch.tensor(scale), torch.tensor(z), torch.tensor(logu))
    close(rect, recj, 1e-5)
    close(xt, xj, 1e-5)
    assert not np.array_equal(xj, x)


def test_tempered_rho_scale_moves_match_jax(one):
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = one

    def run(xx, bb, uu):
        key = jr.PRNGKey(27)
        eps, lu = [], []
        for k in jr.split(key, cmj.K):
            kz, ka = jr.split(k)
            eps.append(jr.normal(kz, dtype=cmj.cdtype))
            lu.append(jnp.log(jr.uniform(ka, dtype=cmj.cdtype)))
        return (jb.rho_scale_moves(cmj, xx, bb, uu, key,
                                   beta=jnp.asarray(BETA)),
                jnp.stack(eps), jnp.stack(lu))

    (xj, bj, uj), eps, logu = _jit(run, x, b, u)
    xt, bt, ut = blocks.rho_scale_moves_core(
        cmt, t64(x), t64(b), t32(u), t64(eps), t64(logu),
        torch.tensor(BETA, dtype=torch.float64))
    close(xt, xj, 1e-10)
    close(bt, bj, 1e-10)
    close(ut, uj, 1e-5, atol=1e-6 * np.abs(uj).max())
    assert not np.array_equal(xj, x)


@pytest.mark.parametrize("kind", ["mh", "refresh"])
def test_tempered_b_draws_match_jax(one, kind):
    """The tempered conditional (N -> N / beta), in the classes of
    ``test_torch_blocks.py``: accept decisions equal where ``|logr -
    logu| > 1e-3``, accepted proposals within 1e-3 proposal standard
    deviations, rejected pulsars unchanged."""
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, b, u = one
    fn = jb.draw_b_mh if kind == "mh" else jb.draw_b_refresh
    zdt = jnp.float32 if kind == "mh" else jnp.float64

    def run(xx, bb, uu):
        key = jr.PRNGKey(28)
        k1, k2 = jr.split(key)
        return (fn(cmj, xx, bb, uu, key, beta=jnp.asarray(BETA)),
                jr.normal(k1, (cmj.P, cmj.Bmax), zdt),
                jnp.log(jr.uniform(k2, (cmj.P,), jnp.float64)))

    (bj, uj, accj), z, logu = _jit(run, x, b, u)
    beta = torch.tensor(BETA, dtype=torch.float64)
    prop = blocks.propose_b_mh if kind == "mh" else blocks.propose_b_refresh
    draw = (blocks.draw_b_mh_core if kind == "mh"
            else blocks.draw_b_refresh_core)
    zt = torch.tensor(z)
    bp, up, logr, ok, L, dj = prop(cmt, t64(x), t64(b), t32(u), zt, beta)
    bt, ut, acct = draw(cmt, t64(x), t64(b), t32(u), zt, t64(logu), beta)
    decided = np.abs(logr.numpy() - logu) > 1e-3
    assert np.array_equal(acct.numpy()[decided], accj[decided])
    assert acct.numpy()[decided].any()
    both = acct.numpy() & accj
    dv = ((bt - t64(bj)) / dj.double())[..., None]
    w = (L.double().transpose(-1, -2) @ dv)[..., 0].numpy()
    assert np.abs(w[both]).max() <= 1e-3
    rej = ~acct.numpy()
    assert np.array_equal(bt.numpy()[rej], b[rej])
    # the tempered proposal is the conditional at N / beta: wider than
    # the untempered one in every pulsar
    L1, dj1 = prop(cmt, t64(x), t64(b), t32(u), zt)[4:]
    assert not torch.equal(dj, dj1)


def test_beta_one_is_the_untempered_block(case):
    """At beta = 1 every tempered block is bitwise its untempered call
    (x * 1.0 and N / 1.0 are exact), and beta None runs the untempered
    arithmetic."""
    cmj, cmt, x, b, u = case
    ones = torch.ones(C, dtype=torch.float64)
    rng = np.random.default_rng(9)
    xt, bt, ut = t64(x), t64(b), t32(u)
    z32 = t32(rng.standard_normal((C, cmt.P, cmt.Bmax)))
    z64 = t64(rng.standard_normal((C, cmt.P, cmt.Bmax)))
    logu = t64(np.log(rng.uniform(size=(C, cmt.P))))
    eps, lu = t64(rng.standard_normal((C, cmt.K))), t64(
        np.log(rng.uniform(size=(C, cmt.K))))
    pairs = [
        (blocks.draw_b_mh_core(cmt, xt, bt, ut, z32, logu),
         blocks.draw_b_mh_core(cmt, xt, bt, ut, z32, logu, ones)),
        (blocks.draw_b_refresh_core(cmt, xt, bt, ut, z64, logu),
         blocks.draw_b_refresh_core(cmt, xt, bt, ut, z64, logu, ones)),
        (blocks.rho_scale_moves_core(cmt, xt, bt, ut, eps, lu),
         blocks.rho_scale_moves_core(cmt, xt, bt, ut, eps, lu, ones))]
    for plain, hot in pairs:
        for p_, h_ in zip(plain, hot):
            assert torch.equal(p_, h_)
    r = cmt.y - ut
    ll = blocks.white_block_ll(cmt, xt, r, r * r)
    assert blocks.tempered_ll(ll, None) is ll
    q = xt + 0.01
    assert torch.equal(blocks.tempered_ll(ll, ones)(q), ll(q).double())


# ---------------------------------------------------------------------------
# the stage in the driver


def _model():
    from pulsar_timing_gibbsspec_torch import build_crn_spectrum

    return build_crn_spectrum(small_psrs(), 4, 4, device="cpu")


OPTS = dict(nchains=C, device="cpu", seed=3, warmup_sweeps=3,
            white_adapt_iters=100, chunk_size=8, progress=False)
NITER = 29


def _run(cm, outdir, niter=NITER, resume=False, **kw):
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs

    g = PTABlockGibbs(cm, **{**OPTS, **kw})
    x0 = g.initial_sample(torch.Generator().manual_seed(1))
    return g, g.sample(x0, outdir=str(outdir), niter=niter, resume=resume,
                       save_every=8)


def test_driver_refuses_what_jax_refuses():
    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs

    cm = _model()
    with pytest.raises(ValueError, match="requires ensemble=True"):
        PTABlockGibbs(cm, nchains=8, device="cpu", pt_ladder=2)
    with pytest.raises(ValueError, match="not a multiple"):
        PTABlockGibbs(cm, nchains=9, device="cpu", ensemble=True,
                      pt_ladder=2)
    with pytest.raises(ValueError, match="must be >= 1"):
        PTABlockGibbs(cm, nchains=8, device="cpu", pt_ladder=0)
    from pulsar_timing_gibbsspec_torch.sampler.driver import \
        TorchGibbsDriver

    cm_pl = ptt.model_general(small_psrs(), tm_svd=True, white_vary=True,
                              common_psd="powerlaw", red_var=False,
                              device="cpu")
    with pytest.raises(ValueError, match="CRN free-spectrum"):
        TorchGibbsDriver(cm_pl, nchains=8, ensemble=True)


def test_stage_off_and_sketch_leave_the_chain_bitwise(tmp_path,
                                                      monkeypatch):
    """With the stage off the sweep is the port's sweep (its blocks, no
    stage block, every block untempered), whether the knob is unset,
    ``PTGIBBS_ENSEMBLE=0`` or ``ensemble=False``; the sketch on changes
    no bit of x, b or the checkpoint's state."""
    cm = _model()
    monkeypatch.delenv("PTGIBBS_ENSEMBLE", raising=False)
    g0, c0 = _run(cm, tmp_path / "a")
    assert g0.driver.ens is None and g0.driver.betas() is None
    assert (g0.driver.sweep_order(False, 5)
            == g0.driver.sweep_blocks(False))
    monkeypatch.setenv("PTGIBBS_ENSEMBLE", "0")
    g1, c1 = _run(cm, tmp_path / "b", obs=True)
    g2, c2 = _run(cm, tmp_path / "c", ensemble=False,
                  obs={"lags": 8, "channels": 6})
    for g, c in ((g1, c1), (g2, c2)):
        assert np.array_equal(c, c0) and np.array_equal(g.bchain, g0.bchain)
        assert np.array_equal(g.driver.x_cur, g0.driver.x_cur)
        assert g.driver.sweep_order(False, 5)[0] == "sketch"
    assert g1.obs_summary()["n"] == NITER - (OPTS["warmup_sweeps"] + 1)
    with pytest.raises(RuntimeError, match="without obs="):
        g0.obs_summary()
    assert g0.ensemble_summary() is None


def test_ensemble_run_resumes_bitwise(tmp_path):
    """A tempered run with the sketch, checkpointed at a chunk boundary,
    resumed in a fresh sampler: chain, bchain and the ensemble state
    bitwise the whole run's; a resume with another ladder, or without the
    stage, raises."""
    cm = _model()
    kw = dict(ensemble=True, pt_ladder=T, obs=True)
    g, whole = _run(cm, tmp_path / "whole", **kw)
    gs, _ = _run(cm, tmp_path / "split", niter=20, **kw)
    gr, resumed = _run(cm, tmp_path / "split", resume=True, **kw)
    assert np.array_equal(resumed, whole)
    assert np.array_equal(gr.bchain, g.bchain)
    for k, v in g.driver._ens_host.items():
        assert np.array_equal(gr.driver._ens_host[k], v)
        assert torch.equal(gr.driver.ens_state[k], g.driver.ens_state[k])
    with np.load(tmp_path / "whole" / "adapt.npz") as z:
        assert int(z["ens_pt_ladder"]) == T
        assert np.array_equal(z["ens_lsp"], g.driver._ens_host["lsp"])
    s = g.ensemble_summary()
    assert s["betas"][0] == 1.0 and 0 < s["betas"][1] < 1
    assert s["sa_steps"] == NITER - (OPTS["warmup_sweeps"] + 1)
    assert all(a > 0 for a in s["stretch_accept"])
    assert g.obs_summary()["ensemble"] == s
    for blk in ("asis", "stretch", "pt_swap"):
        assert g.driver.timer.calls[blk] == s["sa_steps"]
    for bad, match in ((dict(ensemble=True, pt_ladder=1, obs=True),
                        "pt_ladder=2"),
                       (dict(obs=True), "ensemble=False")):
        with pytest.raises(RuntimeError, match=match):
            _run(cm, tmp_path / "split", resume=True, **bad)


def test_sketch_reads_the_exact_carry(tmp_path):
    """The sketch folds the float64 carry of every sweep: its state under
    ``record_every=2`` and bfloat16 records equals the state under 1 and
    float32, bitwise."""
    cm = _model()
    g1, _ = _run(cm, tmp_path / "a", obs=True)
    g2, _ = _run(cm, tmp_path / "b", obs=True, record_every=2,
                 record_precision="bf16")
    for k, v in g1.driver._obs_state.items():
        assert torch.equal(g2.driver._obs_state[k], v), k
    s1, s2 = g1.obs_summary(), g2.obs_summary()
    assert s1["act_rho_med"] == s2["act_rho_med"] >= 1.0
    # a snapshot per writeback: 25 steady sweeps in chunks of 8
    assert len(g1.driver._obs_snaps) == 4


# ---------------------------------------------------------------------------
# the whole slice


def test_tempered_posterior_matches_jax(tmp_path_factory):
    """``PTABlockGibbs(ensemble=True, pt_ladder=2)`` of each package on
    ``small_psrs()`` from one start, 8 chains: on the 4 cold chains, per
    frequency bin, the means of per-chain medians of the common log10_rho
    over the steady rows agree within 5 combined standard errors (the
    ``test_torch_sampler.py`` statistic)."""
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import \
        PTABlockGibbs as JaxGibbs

    warm, niter, adapt = 5, 121, 150
    psrs = small_psrs()
    pta = jax_pta(psrs)
    x0 = pta.initial_sample(np.random.default_rng(0))
    jg = JaxGibbs(pta, backend="jax", nchains=C, seed=0, progress=False,
                  warmup_sweeps=warm, white_adapt_iters=adapt,
                  chunk_size=niter - warm - 1, ensemble=True, pt_ladder=T)
    jchain = jg.sample(x0, outdir=str(tmp_path_factory.mktemp("jax")),
                       niter=niter)
    cm = _model()
    tg = PTABlockGibbs(cm, nchains=C, device="cpu", seed=0,
                       warmup_sweeps=warm, white_adapt_iters=adapt,
                       progress=False, ensemble=True, pt_ladder=T)
    tchain = tg.sample(x0, outdir=str(tmp_path_factory.mktemp("torch")),
                       niter=niter)
    cols = cm.rho_ix_x.numpy()
    cold = np.arange(0, C, T)

    def medians(chain):
        med = np.median(chain[warm + 1:][:, cold][:, :, cols], axis=0)
        return med.mean(0), med.std(0, ddof=1) / np.sqrt(len(cold))

    (mj, sj), (mt, st) = medians(jchain), medians(tchain)
    z = np.abs(mj - mt) / np.sqrt(sj ** 2 + st ** 2)
    assert np.all(z <= 5.0), (mj, mt, z)
    assert np.all((mt > -10) & (mt < -4))
    assert np.isfinite(tchain).all()
    sj_, st_ = jg._backend.ensemble_summary(), tg.ensemble_summary()
    assert st_["sa_steps"] == sj_["sa_steps"] == niter - warm - 1
    assert 0 < st_["betas"][1] < 1 and 0 < st_["swap_rate"][0] < 1
