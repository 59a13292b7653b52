"""Kernel ECORR on the port (``kernel_ecorr=True``, ``ecorrsample=
"kernel"``): ECORR inside N through the Woodbury form, against the JAX
package's ``compile_pta(kernel_ecorr=True)`` and its kernel-ECORR
blocks, on the CPU.

Cases: README's Quick start on JSYN02 flagged NANOGrav (120 TOAs, 3
backends, 107 ECORR epochs leave T: Bmax 18), and a 3-pulsar array with
intrinsic red noise whose first pulsar has no ECORR, padded to 4 pulsars
(its dummy epochs and the pad's carry the -40 constant).  Tolerance
classes:

- model arrays: exact equality, field by field;
- float64 functions of the same inputs (``ke_weights``, ``tnt_d_ke``,
  ``ke_ll_corr``, the b-marginalized likelihood): rel 1e-12 of each
  output's largest entry (the JAX package's scatter-add and the port's
  indicator products sum epochs in other orders); the ECORR block's
  target, at the float32 N each side forms (one float32 rounding
  apart): rel 1e-6; the white block's, the float32 relative form plus
  that correction: 1e-4 absolute on O(10) sums; a dummy epoch's weight
  at most 1e-60;
- ``tnt_d_ke`` against a dense oracle (N built as a matrix, solved by
  ``numpy.linalg.solve``): ``8 eps_f32 max(1, |correction|)`` at the
  corrected Gram's Jacobi scale, as the correction's operand ``T / D`` is
  rounded to float32 first (on both packages);
- the exact draw at the JAX normals: 1e-8 of the largest coefficient at
  one float32 N, 1e-5 where each side forms its own;
- the Laplace mode rel 1e-6 and its factors 1e-5 (compared as
  covariances; the target's float32 D is each side's own), float32 MH
  scans 1e-5;
- chains: per-bin log10_rho and ECORR chain medians within 5 combined
  standard errors; a resumed run bitwise.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.models.build import model_arrays
from pulsar_timing_gibbsspec_torch.sampler import blocks
from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays
from test_torch_cases import (close, cov_noise, jax_fields, nanograv_psr,
                              same_field, small_psrs, state, t32, t64)

torch.set_num_threads(2)

EPS32 = 2.0 ** -23
NB = 4
C, WARM, NITER, ADAPT = 8, 5, 71, 120


def _array_psrs():
    psrs = small_psrs()
    for p in psrs[1:]:
        p.flags = {"pta": "NANOGrav"}
    return psrs


#: (pulsars, model options, compile options) of each case
CASES = {
    "single": (lambda: [nanograv_psr()],
               dict(red_var=False, white_vary=True, common_psd="spectrum",
                    common_components=NB), {}),
    "array": (_array_psrs,
              dict(tm_svd=True, white_vary=True, common_psd="spectrum",
                   common_components=NB, red_psd="spectrum",
                   red_components=3), dict(pad_pulsars=4)),
    "fixed ECORR": (lambda: [nanograv_psr()],
                    dict(red_var=False, white_vary=False,
                         common_psd="spectrum", common_components=NB,
                         noisedict={"JSYN02_be1_log10_ecorr": -7.0,
                                    "JSYN02_be0_efac": 1.1}), {}),
}


def _jax_pta(psrs, **opts):
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    return model_general([Pulsar(**dataclasses.asdict(p)) for p in psrs],
                         **opts)


@functools.lru_cache(maxsize=None)
def models(name):
    """``(jax_cm, port_cm)`` of a case compiled with kernel ECORR, the
    port's from its own ``model_arrays``."""
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    mk, opts, copt = CASES[name]
    psrs = mk()
    cmj = compile_pta(_jax_pta(psrs, **opts), kernel_ecorr=True, **copt)
    return cmj, from_arrays(model_arrays(psrs, kernel_ecorr=True, **copt,
                                         **opts), device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_equals_compile_pta(name):
    """The arrays equal ``compile_pta(kernel_ecorr=True)``'s field by
    field (``ke_eid``, ``ke_par_ix``, the narrowed ``T``, ``phi_base``,
    the empty ``ec_cols``, the ECORR parameter table, the constant
    pool); the flat b names are the JAX facade's under
    ``ecorrsample='kernel'``."""
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import PTABlockGibbs

    mk, opts, copt = CASES[name]
    psrs = mk()
    pta = _jax_pta(psrs, **opts)
    ref = jax_fields(compile_pta(pta, kernel_ecorr=True, **copt))
    got = model_arrays(psrs, kernel_ecorr=True, **copt, **opts)
    assert got["param_names"] == tuple(pta.param_names)
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
    assert got["ec_cols"].shape[1] == 0 and got["ke_eid"] is not None
    jg = PTABlockGibbs.__new__(PTABlockGibbs)
    jg.pta, jg.ecorrsample = pta, "kernel"
    assert list(got["b_names"]) == jg.b_param_names
    if name == "single":
        assert (got["Bmax"], got["ke_par_ix"].shape) == (18, (1, 107))


def test_refusals_match_jax():
    """A model without ECORR is refused with ``compile_pta``'s
    ValueError."""
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    opts = dict(red_var=False, white_vary=True, common_psd="spectrum",
                common_components=NB)
    with pytest.raises(ValueError) as want:
        compile_pta(_jax_pta(small_psrs(), **opts), kernel_ecorr=True)
    with pytest.raises(ValueError) as got:
        model_arrays(small_psrs(), kernel_ecorr=True, **opts)
    assert str(got.value) == str(want.value)


def _vjit(fn, *args):
    import jax
    import jax.numpy as jnp

    out = jax.jit(jax.vmap(fn))(*map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=["single", "array"])
def case(request):
    """``(cmj, cmt, x, q, N, r)``: both models, 2 seeded chain states
    ``x``, a moved state ``q`` (white and ECORR parameters shifted), the
    port's float32 diagonal ``N`` at ``x`` (fed to both sides) and a
    residual ``r = y - T b``."""
    cmj, cmt = models(request.param)
    x = state(cmt, C=2, seed=5)
    rng = np.random.default_rng(6)
    q = x.copy()
    for ix in (cmt.idx.white, cmt.idx.ecorr):
        q[:, ix] += rng.uniform(-0.1, 0.1, (2, len(ix)))
    b = rng.standard_normal((2, cmt.P, cmt.Bmax)) * 1e-7
    r = (cmt.y - blocks.b_matvec(cmt, t64(b))).numpy()
    N = cmt.ndiag_fast(t64(x)).numpy()
    return cmj, cmt, x, q, N, r


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_woodbury_pieces_match_jax(case):
    """``ke_weights``, ``tnt_d_ke`` (and ``tnt_d_x``), ``ke_rz``,
    ``ke_ll_corr``, the kernel-ECORR white and ECORR block targets (at a
    moved state), ``white_block_ll`` / ``ecorr_block_ll`` and the
    b-marginalized likelihood: rel 1e-12; dummy epochs' weights at most
    1e-60."""
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, q, N, r = case

    def run(xx, qq, nn, rr):
        c, s, w = jb.ke_weights(cmj, xx, nn)
        TNT, d = jb.tnt_d_ke(cmj, nn, w)
        TNTx, dx = jb.tnt_d_x(cmj, xx, nn)
        z = jb.ke_rz(cmj, nn, rr)
        r2 = rr * rr
        N64 = cmj.ndiag(xx)
        TNT64, d64 = jb.tnt_d_x(cmj, xx, N64)
        return (c, s, w, TNT, d, TNTx, dx, z, jb.ke_ll_corr(cmj, xx, nn, z),
                jb.white_ll_ke(cmj, xx, rr, r2)(qq),
                jb.ecorr_ll_ke(cmj, xx, rr)(qq),
                jb.white_block_ll(cmj, xx, rr, r2)(qq),
                jb.ecorr_block_ll(cmj, xx, None, rr)(qq),
                jb.lnlike_fullmarg_fn(cmj, xx, TNT64, d64))

    ref = _vjit(run, x, q, N, r.astype(np.float32))
    xt, qt, Nt, rt = t64(x), t64(q), torch.tensor(N), torch.tensor(r)
    c, s, w = blocks.ke_weights(cmt, xt, Nt)
    TNT, d = blocks.tnt_d_ke(cmt, Nt, w)
    TNTx, dx = blocks.tnt_d_x(cmt, xt, Nt)
    z = blocks.ke_rz(cmt, Nt, rt)
    N64 = cmt.ndiag(xt)
    TNT64, d64 = blocks.tnt_d_x(cmt, xt, N64)
    got = (c, s, w, TNT, d, TNTx, dx, z, blocks.ke_ll_corr(cmt, xt, Nt, z),
           blocks.white_ll_ke(cmt, xt, rt, rt * rt)(qt),
           blocks.ecorr_ll_ke(cmt, xt, rt)(qt),
           blocks.white_block_ll(cmt, xt, rt, rt * rt)(qt),
           blocks.ecorr_block_ll(cmt, xt, None, rt)(qt),
           blocks.lnlike_fullmarg_fn(cmt, xt, TNT64, d64))
    names = ("c", "s", "w", "TNT", "d", "TNTx", "dx", "z", "ke_ll_corr",
             "white_ll_ke", "ecorr_ll_ke", "white_block_ll",
             "ecorr_block_ll", "lnlike_fullmarg")
    for nm, a, want in zip(names, got, ref):
        assert a.shape == want.shape[:1] + a.shape[1:], nm
        if nm.startswith("white"):
            # float32 relative form; each side forms its float32 N at q
            close(a, want, 0, atol=1e-4)
        elif nm.startswith("ecorr"):
            # each side forms its float32 N at x itself
            assert _rel(a, want) <= 1e-6, (nm, _rel(a, want))
        else:
            assert _rel(a, want) <= 1e-12, (nm, _rel(a, want))
    assert torch.equal(TNT, TNTx) and torch.equal(d, dx)
    assert np.abs(ref[10]).max() > 1e-3          # the move changes ECORR
    live = cmt.ke_U.sum(-1) > 0
    assert (w[:, ~live].abs() <= 1e-60).all() and (w[:, live] > 0).all()
    if cmt.P > 1:
        assert (~live).any()                     # dummy epochs were held


def test_tnt_d_ke_against_a_dense_oracle(case):
    """``T^T N^-1 [T | y]`` with N built as a dense matrix (diagonal
    plus ``c_e`` on every pair of one epoch) and solved directly."""
    _, cmt, x, _, N, _ = case
    Nt = torch.tensor(N)
    c, _, w = blocks.ke_weights(cmt, t64(x), Nt)
    TNT, d = blocks.tnt_d_ke(cmt, Nt, w)
    TNT0, _ = blocks.tnt_d(cmt, Nt)
    for ci in range(x.shape[0]):
        for p in range(cmt.P_real):
            n = int(cmt.toa_mask[p].sum())
            U = cmt.ke_U[p].numpy()[:, :n]
            Nd = (np.diag(N[ci, p, :n].astype(np.float64))
                  + U.T @ (c[ci, p].numpy()[:, None] * U))
            Ta = np.concatenate([cmt.T[p, :n].double().numpy(),
                                 cmt.y[p, :n, None].double().numpy()], 1)
            G = Ta.T @ np.linalg.solve(Nd, Ta)
            B = cmt.Bmax
            sc = np.sqrt(np.maximum(np.diag(G), 1e-300))
            js = np.outer(sc, sc)
            corr = np.abs(TNT0[ci, p].numpy() - TNT[ci, p].numpy())
            tol = 8 * EPS32 * max(1.0, (corr / js[:B, :B]).max())
            assert (np.abs(TNT[ci, p].numpy() - G[:B, :B])
                    / js[:B, :B]).max() <= tol
            assert (np.abs(d[ci, p].numpy() - G[:B, B])
                    / js[:B, B]).max() <= tol


def test_exact_draw_matches_jax_noise(case):
    """The exact b | everything under kernel ECORR (the Woodbury Gram,
    float64 factor) at the JAX normals: against the JAX draw's own
    arithmetic at the port's float32 N, 1e-8 of the largest coefficient;
    against ``draw_b_fn`` itself, whose float32 N may sit one rounding
    away (amplified by the cancellation under the correction), 1e-5."""
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.ops.linalg import mvn_conditional_draw
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, _, N, _ = case

    def run(xx, nn):
        key = jr.PRNGKey(11)
        z = jr.normal(key, (cmj.P, cmj.Bmax), cmj.cdtype)
        TNT, d = jb.tnt_d_x(cmj, xx, nn)
        same_n, _ = mvn_conditional_draw(TNT, 1.0 / cmj.phi(xx), d, z)
        return jb.draw_b_fn(cmj, xx, key), same_n, z

    bj, bn, z = _vjit(run, x, N.astype(np.float32))
    bt = blocks.draw_b_fn_core(cmt, t64(x), t64(z)).numpy()
    assert np.isfinite(bt).all()
    assert np.abs(bt - bn).max() <= 1e-8 * np.abs(bn).max()
    assert np.abs(bt - bj).max() <= 1e-5 * np.abs(bj).max()


def test_ecorr_laplace_and_scan_match_jax(case):
    """The kernel-ECORR block's Laplace factor (warmup form and the
    adaptation's, with Newton steps) on ``ecorr_ll_ke``'s curvature, and
    one ECORR ``parallel_cov_mh_scan`` with the mixed independence /
    random-walk kernel on the JAX-drawn noise."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt, x, _, _, r = case
    x0, r0 = x[0], r[0].astype(np.float32)
    W = cmt.ecorr_par_ix.shape[1]
    safe = np.minimum(np.asarray(cmj.ecorr_par_ix), cmj.nx - 1)
    steps = 12

    def run(xx, rr):
        curv = jb.ecorr_ll_ke(cmj, xx, rr)
        out = {it: jb.laplace_newton_chol(cmj, xx, curv, cmj.ecorr_par_ix,
                                          cmj.ecorr_nper, newton_iters=it)
               for it in (0, 3)}
        xm, L, asq = out[3]
        mode = xm[safe].astype(jnp.float32)
        key = jr.PRNGKey(3)
        scan = jb.parallel_cov_mh_scan(
            cmj, xm, key, jb.ecorr_block_ll(cmj, xm, None, rr),
            cmj.ecorr_par_ix, cmj.ecorr_nper, L.astype(jnp.float32), steps,
            mode=mode, asqrt=asq.astype(jnp.float32))
        return out, scan, cov_noise(cmj, key, W, steps, True), mode

    lap, (xj, recj), (scale, zz, logu, coin), mode = jax.tree_util.tree_map(
        np.asarray, jax.jit(run)(jnp.asarray(x0), jnp.asarray(r0)))
    rt = torch.tensor(r0)
    for it in (0, 3):
        xm, L, asq = lap[it]
        xt, Lt, asqt = blocks.laplace_newton_chol(
            cmt, t64(x0), blocks.ecorr_ll_ke(cmt, t64(x0), rt),
            cmt.ecorr_par_ix, cmt.ecorr_nper, newton_iters=it)
        close(xt, xm, 1e-6)
        close(Lt @ Lt.transpose(-1, -2), L @ np.swapaxes(L, -1, -2), 1e-5,
              atol=1e-14)
        close(asqt @ asqt.transpose(-1, -2),
              asq @ np.swapaxes(asq, -1, -2), 1e-5, atol=1e-6)
    xm, L, asq = lap[3]
    assert not np.allclose(xm, x0)
    xt, rect = blocks.parallel_cov_mh_scan_core(
        cmt, t64(xm), blocks.ecorr_block_ll(cmt, t64(xm), None, rt),
        cmt.ecorr_par_ix, cmt.ecorr_nper, t32(L), torch.tensor(scale),
        torch.tensor(zz), torch.tensor(logu), coin=torch.tensor(coin),
        mode=t32(mode), asqrt=t32(asq))
    close(rect, recj, 1e-5)
    close(xt, xj, 1e-5)
    assert not np.array_equal(xj, xm)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The Quick start on JSYN02 with kernel ECORR, 8 chains, sampled by
    each package's ``PulsarBlockGibbs(ecorrsample='kernel')`` from one
    start."""
    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import \
        PulsarBlockGibbs as JaxGibbs

    mk, opts, _ = CASES["single"]
    psrs = mk()
    pta = _jax_pta(psrs, **opts)
    x0 = pta.initial_sample(np.random.default_rng(0))
    jg = JaxGibbs(pta, backend="jax", nchains=C, seed=0, progress=False,
                  warmup_sweeps=WARM, white_adapt_iters=ADAPT,
                  chunk_size=NITER - WARM - 1, ecorrsample="kernel")
    jchain = jg.sample(x0, outdir=str(tmp_path_factory.mktemp("jax")),
                       niter=NITER)
    cm = ptt.model_general(psrs, kernel_ecorr=True, device="cpu", **opts)
    tg = ptt.PulsarBlockGibbs(cm, nchains=C, device="cpu", seed=0,
                              warmup_sweeps=WARM, white_adapt_iters=ADAPT,
                              ecorrsample="kernel")
    tchain = tg.sample(x0, outdir=str(tmp_path_factory.mktemp("torch")),
                       niter=NITER)
    return jg, jchain, tg, tchain


def test_posterior_matches_jax(runs):
    """Per-bin common log10_rho and each ECORR amplitude: chain medians
    within 5 combined standard errors (the chain-to-chain spread carries
    the ECORR amplitudes' slow mixing, which a pooled ESS estimate of
    this length misses), and the chains move; the b names and chain
    shapes are the JAX facade's."""
    from test_torch_cases import medians_agree

    jg, jchain, tg, tchain = runs
    cm = tg.cm
    cols = list(cm.rho_ix_x.numpy()) + list(cm.idx.ecorr)
    mt = medians_agree(jchain, tchain, WARM + 1, cols,
                       [cm.param_names[j] for j in cols])
    assert np.all((mt[:cm.K] > -10) & (mt[:cm.K] < -4))
    for chain in (jchain, tchain):
        assert chain[WARM + 1:, :, cm.idx.ecorr].std(0).min() > 1e-3
    assert tg.b_param_names == jg.b_param_names
    for niter in (1, WARM + 2, NITER):
        assert tg.driver.chain_shapes(niter) == \
            jg._backend.chain_shapes(niter)


def test_one_steady_body(runs):
    """Every steady sweep is white, ECORR, rho, then the exact b-draw
    (no scale moves, no Metropolised draw: ``exact_every`` is 1), in the
    warmup too; both sub-chains are ACT-sized."""
    _, _, tg, tchain = runs
    drv = tg.driver
    assert drv.sweep_blocks(False) == drv.sweep_blocks(True) == [
        "white", "ecorr", "rho", "b_exact"]
    assert drv.exact_every == 1 and drv.b_mh_sweeps == 0
    assert drv.b_refresh_sweeps == NITER - WARM - 1
    assert drv.timer.calls["b_exact"] == NITER - 1
    assert "scale" not in drv.timer.calls
    assert 1 <= drv.aclength_ecorr <= drv.white_steps_max
    assert np.isfinite(tchain).all() and np.isfinite(tg.bchain).all()


def test_split_and_resumed_run_is_bitwise(tmp_path):
    """A kernel-ECORR run split at a chunk boundary and resumed in a
    fresh sampler equals the uninterrupted one bitwise; ``adapt.npz``
    carries the ECORR adaptation."""
    import pulsar_timing_gibbsspec_torch as ptt

    cm = models("single")[1]

    def gibbs():
        return ptt.PulsarBlockGibbs(cm, nchains=2, device="cpu", seed=0,
                                    warmup_sweeps=3, white_adapt_iters=100,
                                    chunk_size=8, ecorrsample="kernel")

    def x0(g):
        return g.initial_sample(torch.Generator().manual_seed(3))

    g = gibbs()
    g.sample(x0(g), outdir=tmp_path / "whole", niter=28, save_every=8)
    g1 = gibbs()
    g1.sample(x0(g1), outdir=tmp_path / "split", niter=20, save_every=8)
    g2 = gibbs()
    g2.sample(x0(g2), outdir=tmp_path / "split", niter=28, resume=True,
              save_every=8)
    for nm in ("chain.npy", "bchain.npy"):
        assert np.array_equal(np.load(tmp_path / "whole" / nm),
                              np.load(tmp_path / "split" / nm)), nm
    with np.load(tmp_path / "whole" / "adapt.npz") as z:
        assert "chol_ecorr" in z.files and int(z["aclength_ecorr"]) >= 1


def test_facade_refuses_a_compile_mode_mismatch():
    """``ecorrsample='kernel'`` on a basis-ECORR model and
    ``ecorrsample='mh'`` on a kernel-ECORR model raise ValueError naming
    the compile option; nothing is recompiled.  ``None`` follows the
    model, and a model without ECORR refuses ``'kernel'`` with the JAX
    package's message."""
    import types

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.sampler.blocks import \
        validate_sampling_flags as ours
    from pulsar_timing_gibbsspec_tpu.sampler.blocks import \
        validate_sampling_flags as theirs

    mk, opts, _ = CASES["single"]
    basis = ptt.model_general(mk(), device="cpu", **opts)
    kern = models("single")[1]
    with pytest.raises(ValueError, match="kernel_ecorr=True"):
        ptt.PulsarBlockGibbs(basis, device="cpu", ecorrsample="kernel")
    with pytest.raises(ValueError, match="kernel_ecorr=True"):
        ptt.PulsarBlockGibbs(kern, device="cpu", ecorrsample="mh")
    assert not basis.has_ke and kern.has_ke
    assert ptt.PulsarBlockGibbs(kern, device="cpu").driver.do_ecorr
    none = ptt.model_general(small_psrs()[:1], red_var=False,
                             white_vary=True, common_psd="spectrum",
                             common_components=NB, device="cpu")
    model = types.SimpleNamespace(param_names=none.param_names)
    errs = []
    for fn in (ours, theirs):
        with pytest.raises(ValueError) as e:
            fn(model, None, "kernel", None)
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    with pytest.raises(ValueError):
        ptt.PulsarBlockGibbs(none, device="cpu", ecorrsample="kernel")
