"""The single-pulsar path: the port's ``PulsarBlockGibbs`` against the
JAX package's on README's Quick-start model of a small synthetic pulsar
flagged NANOGrav (JSYN02: 120 TOAs, 3 backends, basis ECORR, Bmax = 125,
13 parameters), on the CPU.

- Posterior (f): both run 8 chains from one start through warmup,
  adaptation and steady sweeps.  Per frequency bin, each chain's median
  of log10_rho over the steady rows; chains are independent, so the
  chain-to-chain spread gives the Monte-Carlo standard error of the mean
  of those medians on each side, and the two means must agree within 5
  combined standard errors.  Each ECORR amplitude: the median of the
  pooled steady rows on each side, with the Monte-Carlo variance of a
  median, (pi / 2) var / ESS, the ESS summed over chains from each
  chain's integrated ACT (the ESS-aware z-test of
  tests/test_enterprise_snapshot.py, for medians); z < 4.5.
- Resume (g): a run split at a chunk boundary and resumed in a fresh
  sampler equals the uninterrupted one bitwise; ``adapt.npz`` carries
  the ECORR adaptation, and a checkpoint without it is refused.
- Layout (h, i): ``b_param_names`` and ``chain_shapes`` equal the JAX
  facade's; the JAX package's ``integrity.verify`` accepts the port's
  checkpoint directory.
"""

import numpy as np
import pytest
import torch

from test_torch_cases import jax_single_pta, nanograv_psr, single_models

torch.set_num_threads(2)

C, WARM, NITER, ADAPT = 8, 5, 81, 120
#: the resume case: chains, warmup, chunk, whole run and split
RC, RWARM, RCHUNK, RNITER, RSPLIT = 2, 3, 8, 28, 20


def _port_gibbs(cm, **kw):
    from pulsar_timing_gibbsspec_torch import PulsarBlockGibbs

    return PulsarBlockGibbs(cm, device="cpu", seed=0, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from pulsar_timing_gibbsspec_torch import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import \
        PulsarBlockGibbs as JaxGibbs

    psr = nanograv_psr()
    pta = jax_single_pta(psr)
    x0 = pta.initial_sample(np.random.default_rng(0))
    jg = JaxGibbs(pta, backend="jax", nchains=C, seed=0, progress=False,
                  warmup_sweeps=WARM, white_adapt_iters=ADAPT,
                  chunk_size=NITER - WARM - 1)
    jchain = jg.sample(x0, outdir=str(tmp_path_factory.mktemp("jax")),
                       niter=NITER)
    cm = model_general([psr], red_var=False, white_vary=True,
                       common_psd="spectrum", common_components=4,
                       device="cpu")
    assert list(cm.param_names) == list(pta.param_names)
    tg = _port_gibbs(cm, nchains=C, warmup_sweeps=WARM,
                     white_adapt_iters=ADAPT)
    out = tmp_path_factory.mktemp("torch")
    tchain = tg.sample(x0, outdir=str(out), niter=NITER)
    return jg, jchain, tg, tchain, out


def test_rho_posterior_matches_jax(runs):
    """(f) Per-bin common log10_rho: chain medians' means within 5
    combined standard errors, inside the prior."""
    _, jchain, tg, tchain, _ = runs
    cols = tg.cm.rho_ix_x.numpy()

    def medians(chain):
        med = np.median(chain[WARM + 1:][:, :, cols], axis=0)   # (C, K)
        return med.mean(0), med.std(0, ddof=1) / np.sqrt(med.shape[0])

    mj, sj = medians(jchain)
    mt, st = medians(tchain)
    z = np.abs(mj - mt) / np.sqrt(sj ** 2 + st ** 2)
    assert np.all(z <= 5.0), (mj, mt, z)
    assert np.all((mt > -10) & (mt < -4))


def test_ecorr_posterior_matches_jax(runs):
    """(f) Each ECORR amplitude's pooled median, ESS-aware z < 4.5, and
    the chains move."""
    from pulsar_timing_gibbsspec_torch.ops.acf import integrated_act_columns

    _, jchain, tg, tchain, _ = runs

    def median_and_var(chain, k):
        s = chain[WARM + 1:, :, k]                                 # (n, C)
        acts = np.maximum(integrated_act_columns(s), 1.0)
        ess = float((s.shape[0] / acts).sum())
        return np.median(s), 0.5 * np.pi * s.var() / ess, s.std(0).min()

    for k in tg.cm.idx.ecorr:
        ma, va, sa = median_and_var(jchain, k)
        mb, vb, sb = median_and_var(tchain, k)
        z = abs(ma - mb) / np.sqrt(va + vb)
        assert z < 4.5, (tg.param_names[k], ma, mb, z)
        assert sa > 1e-3 and sb > 1e-3


def test_single_pulsar_schedule(runs):
    """Every steady sweep ran the white and ECORR blocks before rho and
    the scale moves (no red block), the b-draws on the refresh schedule;
    both sub-chains are ACT-sized within 2x of the JAX package's."""
    jg, _, tg, tchain, _ = runs
    drv = tg.driver
    steady = range(WARM + 1, NITER)
    n_ref = sum(t % drv.exact_every == 0 for t in steady)
    assert drv.sweep_blocks(False) == ["white", "ecorr", "rho", "scale",
                                       "b_mh"]
    for blk in ("white", "ecorr", "rho", "scale"):
        assert drv.timer.calls[blk] == WARM + len(steady)
    assert "red" not in drv.timer.calls
    assert drv.timer.calls["b_mh"] == drv.b_mh_sweeps == len(steady) - n_ref
    assert (drv.b_mh_accepts / drv.b_mh_sweeps).mean() > 0.9
    assert np.isfinite(tchain).all() and np.isfinite(tg.bchain).all()
    jd = jg._backend
    for name in ("white", "ecorr"):
        ours, theirs = (getattr(d, f"aclength_{name}") for d in (drv, jd))
        assert 1 <= ours <= drv.white_steps_max
        assert theirs / 2 <= ours <= 2 * theirs, (name, ours, theirs)


def test_layout_matches_jax_facade(runs):
    """(h, i) ``b_param_names`` (ECORR columns named
    ``<pulsar>_basis_ecorr_<j>``) and ``chain_shapes`` equal the JAX
    facade's; the JAX package's ``integrity.verify`` accepts the port's
    checkpoint, whose layout names the facade."""
    import json

    from pulsar_timing_gibbsspec_tpu.runtime import integrity as jint

    jg, _, tg, _, out = runs
    assert tg.b_param_names == jg.b_param_names
    assert sum(n.startswith("JSYN02_basis_ecorr_")
               for n in tg.b_param_names) == 107
    assert (out / "pars_bchain.txt").read_text().split() == tg.b_param_names
    for niter in (1, 2, WARM + 1, WARM + 2, 37, NITER):
        assert tg.driver.chain_shapes(niter) == \
            jg._backend.chain_shapes(niter), niter
    rep = jint.verify(out)
    assert rep["ok"] and rep["rows"] == NITER
    layout = json.loads((out / "manifest.json").read_text())["layout"]
    assert layout["facade"] == "PulsarBlockGibbs"
    assert layout["pulsars"] == ["JSYN02"]


@pytest.fixture(scope="module")
def resume_case(tmp_path_factory):
    cm = single_models()[1]

    def gibbs():
        return _port_gibbs(cm, nchains=RC, warmup_sweeps=RWARM,
                           white_adapt_iters=100, chunk_size=RCHUNK)

    def x0(g):
        return g.initial_sample(torch.Generator().manual_seed(3))

    whole = tmp_path_factory.mktemp("whole")
    split = tmp_path_factory.mktemp("split")
    g = gibbs()
    g.sample(x0(g), outdir=whole, niter=RNITER, save_every=RCHUNK)
    g1 = gibbs()
    g1.sample(x0(g1), outdir=split, niter=RSPLIT, save_every=RCHUNK)
    g2 = gibbs()
    g2.sample(x0(g2), outdir=split, niter=RNITER, resume=True,
              save_every=RCHUNK)
    return cm, g, g2, whole, split, gibbs


def test_split_and_resumed_run_is_bitwise(resume_case):
    """(g) Split at a chunk boundary and resumed in a fresh sampler: the
    chain files equal the uninterrupted run's bitwise."""
    cm, g, g2, whole, split, _ = resume_case
    for nm in ("chain.npy", "bchain.npy"):
        assert np.array_equal(np.load(whole / nm), np.load(split / nm)), nm
    assert np.array_equal(g.chain, g2.chain)
    assert g2.driver.aclength_ecorr == g.driver.aclength_ecorr


def test_adapt_state_carries_ecorr(resume_case, tmp_path):
    """(g) ``adapt.npz`` holds the ECORR adaptation (``aclength_ecorr``,
    ``chol_ecorr``, ``mode_ecorr``, ``asqrt_ecorr``, per chain); a
    checkpoint without it is refused with the JAX package's message."""
    cm, g, _, whole, _, gibbs = resume_case
    W = cm.ecorr_par_ix.shape[1]
    with np.load(whole / "adapt.npz") as z:
        state = dict(z)
    assert int(state["aclength_ecorr"]) == g.driver.aclength_ecorr
    for key in ("chol_ecorr", "asqrt_ecorr"):
        assert state[key].shape == (RC, cm.P, W, W)
    assert state["mode_ecorr"].shape == (RC, cm.P, W)
    assert np.isfinite(state["chol_ecorr"]).all()
    state.pop("chol_ecorr")
    with pytest.raises(RuntimeError, match="lacks ECORR adaptation state"):
        gibbs().driver.load_adapt_state(state)


def test_pulsar_facade_takes_one_pulsar():
    from pulsar_timing_gibbsspec_torch import build_crn_spectrum
    from test_torch_cases import small_psrs

    with pytest.raises(ValueError, match="one pulsar"):
        _port_gibbs(build_crn_spectrum(small_psrs(), 4, 4, device="cpu"))
