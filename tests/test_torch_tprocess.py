"""The t-process and ``infinitepower`` red PSDs on the port, against the
JAX package on the CPU.

Models: ``model_general(psrs, tm_svd=True, white_vary=True,
common_psd="spectrum", red_psd="tprocess" | "infinitepower")`` on the
synthetic 3-pulsar array at 4 bins (and the t-process under
``upper_limit``, and on one NANOGrav-flagged pulsar with ECORR).
Tolerance classes:

- model arrays: exact equality, field by field (``red_f``, ``red_df``,
  the InvGamma alphas' prior kind 3 and their proposal scale included);
- at 8 seeded states (float64): ``phi``, ``phi_hyper_split``'s parts,
  ``red_phi``, ``gw_phi_at_red`` and ``lnlike_hyper_fn`` to rel 1e-12,
  float32 ``phi`` to 2e-6, ``lnprior`` to one float32 ulp per
  parameter, ``lnlike_fullmarg_fn`` to rel 1e-9;
- the alpha draw's core fed the JAX-drawn Gumbel noise: the same grid
  index for every (chain, pulsar, bin), the alphas to rel 1e-12;
- the conjugate limits: with the common variance at the bottom of its
  prior the draws' quartiles are InvGamma(2, 1 + tau / plaw)'s, with it
  dominating they are the prior's, within 0.1 dex (the grid's
  discretization), as the JAX package's test holds its own draw;
- chains: per-bin common log10_rho, red log10_A / gamma and log10 alpha
  chain medians within 5 combined standard errors of the JAX
  package's; a resumed run bitwise.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from scipy import stats

from pulsar_timing_gibbsspec_torch.models.build import model_arrays
from pulsar_timing_gibbsspec_torch.sampler import blocks
from test_torch_cases import (close, jax_fields, medians_agree, nanograv_psr,
                              same_field, small_psrs, state, t64)

torch.set_num_threads(2)

NB = 4
BASE = dict(tm_svd=True, white_vary=True, common_psd="spectrum",
            common_components=NB, red_components=NB)
CASES = {
    "tprocess": ("small", dict(red_psd="tprocess")),
    "tprocess upper_limit": ("small", dict(red_psd="tprocess",
                                           upper_limit=True)),
    "tprocess ECORR": ("ng", dict(red_psd="tprocess", red_components=3)),
    "infinitepower": ("small", dict(red_psd="infinitepower")),
}
C, WARM, NITER, ADAPT, RADAPT = 8, 5, 61, 100, 200


def _psrs(which):
    return small_psrs() if which == "small" else [nanograv_psr()]


def _jax_pta(psrs, **opts):
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    return model_general([Pulsar(**dataclasses.asdict(p)) for p in psrs],
                         **opts)


@functools.lru_cache(maxsize=None)
def models(name):
    """``(jax_cm, port_cm)`` of a case, the port's from its own
    ``model_general``."""
    from pulsar_timing_gibbsspec_torch import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    which, opts = CASES[name]
    opts = dict(BASE, **opts)
    psrs = _psrs(which)
    return (compile_pta(_jax_pta(psrs, **opts)),
            model_general(psrs, device="cpu", **opts))


def tp_state(cm, n, seed):
    """:func:`state` with the red powerlaw hypers inside their priors
    (log10_A in [-15, -12.5], gamma in [2, 5]) and the alphas
    log-uniform over [0.1, 10]."""
    x = state(cm, C=n, seed=seed)
    rng = np.random.default_rng(seed + 50)
    for j, nm in enumerate(cm.param_names):
        if nm.endswith("_log10_A"):
            x[:, j] = rng.uniform(-15.0, -12.5, n)
        elif nm.endswith("_gamma"):
            x[:, j] = rng.uniform(2.0, 5.0, n)
        elif "_alphas_" in nm:
            x[:, j] = 10.0 ** rng.uniform(-1.0, 1.0, n)
    return x


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_equals_compile_pta(name):
    """The port's arrays equal ``compile_pta``'s field by field; the b
    names are the JAX facade's; the alphas have prior kind 3 (InvGamma(1,
    1)) and belong to no MH block."""
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import PTABlockGibbs

    which, opts = CASES[name]
    opts = dict(BASE, **opts)
    psrs = _psrs(which)
    pta = _jax_pta(psrs, **opts)
    ref = jax_fields(compile_pta(pta))
    got = model_arrays(psrs, **opts)
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
    jg = PTABlockGibbs.__new__(PTABlockGibbs)
    jg.pta, jg.ecorrsample = pta, None
    assert list(got["b_names"]) == jg.b_param_names
    alphas = [j for j, n in enumerate(got["param_names"]) if "_alphas_" in n]
    if opts["red_psd"] == "tprocess":
        assert alphas and (got["pkind"][alphas] == 3).all()
        assert (got["pa"][alphas] == 1).all() and (got["pb"][alphas] == 1).all()
        cm = models(name)[1]
        blocks_ = [cm.idx.rho, cm.idx.red, cm.idx.red_rho, cm.idx.white,
                   cm.idx.ecorr]
        assert not set(alphas) & set(np.concatenate(blocks_).tolist())
    else:
        assert not alphas and got["red_kind"] == "infinitepower"


@pytest.mark.parametrize("name", ["tprocess", "tprocess ECORR",
                                  "infinitepower"])
def test_phi_and_likelihoods_match_jax(name):
    """8 states: phi (float64, float32), phi_hyper_split's parts,
    red_phi, gw_phi_at_red, lnprior, lnlike_hyper_fn (with and without
    phi_fn) and lnlike_fullmarg_fn at the classes of the module
    docstring."""
    import jax
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models(name)
    x = tp_state(cmt, 8, seed=1)
    b = np.random.default_rng(3).normal(size=(8, cmt.P, cmt.Bmax)) * 1e-7

    def jax_side(x, b):
        static, dyn = cmj.phi_hyper_split(x)
        TNT, d = jb.tnt_d_x(cmj, x, cmj.ndiag(x))
        return dict(phi=cmj.phi(x), phi32=cmj.phi(x, dtype=jnp.float32),
                    static=static, dyn=dyn(x), red_phi=cmj.red_phi(x),
                    other=cmj.gw_phi_at_red(x), lnprior=cmj.lnprior(x),
                    hyper=jb.lnlike_hyper_fn(cmj, x, b),
                    hyper_dyn=jb.lnlike_hyper_fn(cmj, x, b, phi_fn=dyn),
                    full=jb.lnlike_fullmarg_fn(cmj, x, TNT, d))

    ref = {k: np.asarray(v)
           for k, v in jax.jit(jax.vmap(jax_side))(x, b).items()}
    xt, bt = t64(x), t64(b)
    static, dyn = cmt.phi_hyper_split(xt)
    close(cmt.phi(xt), ref["phi"], 1e-12)
    close(cmt.phi(xt, dtype=torch.float32), ref["phi32"], 2e-6)
    close(static, ref["static"], 1e-12)
    close(dyn(xt), ref["dyn"], 1e-12)
    close(cmt.red_phi(xt), ref["red_phi"], 1e-12)
    close(cmt.gw_phi_at_red(xt), ref["other"], 1e-12)
    close(cmt.lnprior(xt), ref["lnprior"], 0, atol=cmt.nx * 4 * 2.0 ** -23)
    close(blocks.lnlike_hyper_fn(cmt, xt, bt), ref["hyper"], 1e-12)
    close(blocks.lnlike_hyper_fn(cmt, xt, bt, phi_fn=dyn), ref["hyper_dyn"],
          1e-12)
    TNT, d = blocks.tnt_d_x(cmt, xt, cmt.ndiag(xt))
    close(blocks.lnlike_fullmarg_fn(cmt, xt, TNT, d), ref["full"], 1e-9)
    assert np.isfinite(ref["lnprior"]).all()
    if name == "infinitepower":
        assert (cmt.red_phi(xt)[..., :cmt.Kr] == 1e30).all()


def _grid_index(alpha):
    lo, hi, n = (blocks.TP_ALPHA_LOG10_MIN, blocks.TP_ALPHA_LOG10_MAX,
                 blocks.TP_ALPHA_GRID)
    return np.rint((np.log10(alpha) - lo) / (hi - lo) * (n - 1)).astype(int)


@pytest.mark.parametrize("name", ["tprocess", "tprocess ECORR"])
def test_alpha_core_picks_the_jax_grid_index(name):
    """``tprocess_alpha_update_core`` fed the Gumbel noise the JAX
    ``tprocess_alpha_update`` draws from its key picks the same grid
    point for every (chain, pulsar, bin) and writes nothing else."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models(name)
    n = 6
    x = tp_state(cmt, n, seed=4)
    rng = np.random.default_rng(8)
    b = rng.normal(size=(n, cmt.P, cmt.Bmax)) * 10.0 ** rng.uniform(
        -8.0, -6.0, (n, 1, cmt.Bmax))
    keys = jr.split(jr.key(12), n)
    shape = tuple(cmt.red_rho_ix_x.shape) + (blocks.TP_ALPHA_GRID,)

    def run(xx, bb, kk):
        return (jb.tprocess_alpha_update(cmj, xx, bb, kk),
                jr.gumbel(kk, shape, dtype=jnp.float32))

    xj, gum = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(run))(
        jnp.asarray(x), jnp.asarray(b), keys))
    xt = blocks.tprocess_alpha_update_core(cmt, t64(x), t64(b),
                                           torch.tensor(gum)).numpy()
    al = [j for j, nm in enumerate(cmt.param_names) if "_alphas_" in nm]
    rest = [j for j in range(cmt.nx) if j not in al]
    assert np.array_equal(xt[:, rest], x[:, rest])
    assert np.array_equal(_grid_index(xt[:, al]), _grid_index(xj[:, al]))
    close(xt[:, al], xj[:, al], 1e-12)
    assert not np.allclose(xt[:, al], x[:, al])
    # a fresh draw from the port's own generator lands on the grid too
    out = blocks.tprocess_alpha_update(cmt, t64(x), t64(b),
                                       torch.Generator().manual_seed(0))
    a = out[:, al].numpy()
    assert np.allclose(10.0 ** ((_grid_index(a) / 999.0) * 14.0 - 4.0), a,
                       rtol=1e-9)


def _quantiles_match(draws, dists, tol=0.1):
    for k in range(draws.shape[1]):
        dist = dists[k] if isinstance(dists, list) else dists
        for q in (0.25, 0.5, 0.75):
            emp = np.log10(np.quantile(draws[:, k], q))
            assert abs(emp - np.log10(dist.ppf(q))) < tol, (k, q)


def test_conjugate_limits():
    """With the common process at the bottom of its prior (o -> 0) the
    alpha draw is the conjugate InvGamma(2, 1 + tau / plaw); with the
    common process dominating the shared columns it is the InvGamma(1,
    1) prior (``tests/test_tprocess.py``'s limits, on the port's
    draw)."""
    from pulsar_timing_gibbsspec_torch.sampler.compiled import (
        _lnphi_powerlaw)

    _, cm = models("tprocess")
    n = 800
    x = np.repeat(tp_state(cm, 1, seed=2), n, axis=0)
    for j, nm in enumerate(cm.param_names):
        if "red_noise_log10_A" in nm:
            x[:, j] = -13.5
        elif "red_noise_gamma" in nm:
            x[:, j] = 3.0
    b = np.repeat(np.random.default_rng(1).standard_normal(
        (1, cm.P, cm.Bmax)) * 1e-7, n, axis=0)
    al = [j for j, nm in enumerate(cm.param_names)
          if nm.startswith("JSYN00_red_noise_alphas_")]
    gen = torch.Generator().manual_seed(5)

    x1 = x.copy()
    x1[:, cm.rho_ix_x.numpy()] = -10.0
    draws = blocks.tprocess_alpha_update(cm, t64(x1), t64(b), gen).numpy()
    tau = cm.red_tau(t64(b[:1]))[0, 0].numpy()
    xev = cm.xe(t64(x1[:1]))
    args = [xev[..., cm.red_hyp_ix[:, h]][..., None] for h in range(2)]
    plaw = torch.exp(_lnphi_powerlaw(cm.red_f, cm.red_df, *args))[0, 0]
    rate = 1.0 + tau / plaw.numpy()
    _quantiles_match(draws[:, al], [stats.invgamma(a=2.0, scale=r)
                                    for r in rate])

    x2 = x.copy()
    x2[:, cm.rho_ix_x.numpy()] = -4.0
    draws = blocks.tprocess_alpha_update(cm, t64(x2), t64(b), gen).numpy()
    _quantiles_match(draws[:, al], stats.invgamma(a=1.0, scale=1.0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The t-process array sampled by each package's ``PTABlockGibbs``
    from one start, 8 chains."""
    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import \
        PTABlockGibbs as JaxGibbs

    opts = dict(BASE, red_psd="tprocess")
    psrs = small_psrs()
    pta = _jax_pta(psrs, **opts)
    x0 = pta.initial_sample(np.random.default_rng(0))
    kw = dict(nchains=C, seed=0, warmup_sweeps=WARM,
              white_adapt_iters=ADAPT, red_adapt_iters=RADAPT)
    jg = JaxGibbs(pta, backend="jax", progress=False,
                  chunk_size=NITER - WARM - 1, **kw)
    jchain = jg.sample(x0, outdir=str(tmp_path_factory.mktemp("jax")),
                       niter=NITER)
    cm = ptt.model_general(psrs, device="cpu", **opts)
    tg = ptt.PTABlockGibbs(cm, device="cpu", **kw)
    tchain = tg.sample(x0, outdir=str(tmp_path_factory.mktemp("torch")),
                       niter=NITER)
    return jg, jchain, tg, tchain


def test_chains_match_jax(runs):
    """Per-bin common log10_rho, the red powerlaw hypers and log10 of
    every alpha: chain medians within 5 combined standard errors; the
    sweep runs the alpha draw between the white and powerlaw blocks;
    every alpha finite and positive."""
    jg, jchain, tg, tchain = runs
    cm = tg.cm
    names = list(cm.param_names)
    al = [j for j, n in enumerate(names) if "_alphas_" in n]
    cols = list(cm.rho_ix_x.numpy()) + list(cm.idx.red)
    medians_agree(jchain, tchain, WARM + 1, cols, [names[j] for j in cols])
    lj, lt = np.log10(jchain[..., al]), np.log10(tchain[..., al])
    medians_agree(lj, lt, WARM + 1, np.arange(len(al)),
                  [names[j] for j in al])
    assert (tchain[..., al] > 0).all() and np.isfinite(tchain).all()
    drv = tg.driver
    assert drv.sweep_blocks(False) == ["white", "tprocess", "red_mh", "rho",
                                       "scale", "b_mh"]
    assert drv.do_tprocess and not drv.do_red_conditional
    assert drv.timer.calls["tprocess"] == NITER - 1
    assert tg.b_param_names == jg.b_param_names


def test_split_and_resumed_run_is_bitwise(tmp_path):
    """A t-process run split at a chunk boundary and resumed in a fresh
    sampler equals the uninterrupted one bitwise."""
    import pulsar_timing_gibbsspec_torch as ptt

    _, cm = models("tprocess")

    def gibbs():
        return ptt.PTABlockGibbs(cm, nchains=2, device="cpu", seed=0,
                                 warmup_sweeps=3, white_adapt_iters=60,
                                 red_adapt_iters=120, chunk_size=8)

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


def test_infinitepower_chain_runs(tmp_path):
    """``red_psd='infinitepower'``: no red hypers, no red block; the
    common rho sees ``BIG_PHI`` as the red variance on the shared
    columns; a short chain is finite."""
    import pulsar_timing_gibbsspec_torch as ptt

    _, cm = models("infinitepower")
    g = ptt.PTABlockGibbs(cm, nchains=2, device="cpu", seed=0,
                          warmup_sweeps=3, white_adapt_iters=60)
    chain = g.sample(g.initial_sample(torch.Generator().manual_seed(1)),
                     outdir=tmp_path, niter=12)
    assert np.isfinite(chain).all() and np.isfinite(g.bchain).all()
    assert g.driver.sweep_blocks(False) == ["white", "rho", "scale", "b_mh"]
    assert len(cm.idx.red) == 0 and cm.red_kind == "infinitepower"
