"""Fixed white noise and the chromatic GPs in the whole sampler (CPU):
the port's facades against the JAX package's.

- Posterior: the array model of ``chip_smoke.py`` phase 11 at the 3
  pulsars of ``small_psrs`` and 4 bins (fixed EFAC/EQUAD from a seeded
  noise dictionary, common free spectrum, red powerlaw, a DM powerlaw
  GP, ``dm_annual``), ``PTABlockGibbs`` on both sides, 8 chains from one
  start, 5 warmup sweeps, the adaptation, 75 steady sweeps; every red
  and DM ``log10_A``/``gamma`` and common ``log10_rho``: the means over
  chains of the chains' steady medians agree within 5 combined
  Monte-Carlo standard errors (the chains' spread).
- No white and no ECORR block: with nothing sampled in them, the steady
  sweep, the adaptation and ``adapt.npz`` hold neither, on both sides
  (the JAX driver's adaptation state has no white or ECORR entry
  either); the same with basis ECORR columns whose variances are
  constants (JSYN02 flagged NANOGrav, fixed ECORR).
- Resume: a 2-chain run of the posterior's model split at a chunk
  boundary and resumed in a fresh sampler equals the whole run
  bitwise, and so does one of the fixed-ECORR single pulsar.
"""

import numpy as np
import pytest
import torch

from test_torch_cases import (medians_agree, nanograv_psr, run_both,
                              small_psrs)

from pulsar_timing_gibbsspec_torch.data import synthetic_noisedict

torch.set_num_threads(2)

NB = 4
#: the adaptation entries a driver keeps for white noise and ECORR
WHITE_KEYS = {f"{k}_{b}" for k in ("aclength", "chol", "mode", "asqrt")
              for b in ("white", "ecorr")}
#: the array model (phase 11's options at 4 bins) and the fixed-ECORR
#: single pulsar
ARRAY = dict(tm_svd=True, common_psd="spectrum", common_components=NB,
             red_psd="powerlaw", red_components=NB, dm_var=True,
             dm_components=NB, dm_annual=True)
SINGLE = dict(common_psd="spectrum", common_components=NB,
              red_psd="powerlaw", red_components=NB, dm_var=True,
              dm_components=NB, bayesephem=True)
#: the resume runs: chains, warmup, chunk, whole run, split row
RC, RWARM, RCHUNK, RNITER, RSPLIT = 2, 3, 8, 44, 28


@pytest.fixture(scope="module")
def posterior(tmp_path_factory):
    psrs = small_psrs()
    return run_both(
        tmp_path_factory, psrs, "PTABlockGibbs", nchains=8, warmup=5,
        niter=81, white_adapt=120, red_adapt=200, white_vary=False,
        noisedict=synthetic_noisedict(psrs, 3), **ARRAY)


def test_posterior_matches_jax(posterior):
    """Every red and DM log10_A / gamma and every common log10_rho."""
    _, jchain, tg, tchain, _ = posterior
    cm = tg.cm
    names = [cm.param_names[j] for j in cm.idx.red]
    assert len(names) == 12 and sum("_dm_gp_" in n for n in names) == 6
    cols = [int(j) for j in cm.idx.red] + cm.rho_ix_x.tolist()
    medians_agree(jchain, tchain, 6, cols, [cm.param_names[j] for j in cols])
    assert np.isfinite(tchain).all()


def test_no_white_block_on_either_side(posterior):
    """The sweep is red_mh, rho, scale, b_mh (b_refresh on the 16th):
    no white block, and no white adaptation in the drivers' states or
    the checkpoint; both sides keep the powerlaw block's."""
    jg, _, tg, _, out = posterior
    drv = tg.driver
    assert not drv.do_white and not drv.do_ecorr
    assert drv.sweep_blocks(False) == ["red_mh", "rho", "scale", "b_mh"]
    assert drv.sweep_blocks(True)[-1] == "b_refresh"
    theirs = set(jg._backend.adapt_state())
    with np.load(out / "adapt.npz") as z:
        ours = set(z.files)
    assert not (theirs | ours) & WHITE_KEYS
    assert {"cov_red", "red_hist"} <= theirs & ours


def resume_runs(tmp_path_factory, facade, cm):
    """``(whole, split, sampler)``: a run of ``RNITER`` sweeps, and one
    split at row ``RSPLIT`` then resumed in a fresh sampler."""
    import pulsar_timing_gibbsspec_torch as ptt

    def gibbs():
        return getattr(ptt, facade)(cm, nchains=RC, device="cpu", seed=0,
                                    warmup_sweeps=RWARM, red_adapt_iters=120,
                                    red_steps=5, chunk_size=RCHUNK)

    def x0(g):
        return g.initial_sample(torch.Generator().manual_seed(3))

    whole = tmp_path_factory.mktemp("whole")
    split = tmp_path_factory.mktemp("split")
    g = gibbs()
    g.sample(x0(g), outdir=whole, niter=RNITER)
    g1 = gibbs()
    g1.sample(x0(g1), outdir=split, niter=RSPLIT)
    g2 = gibbs()
    g2.sample(x0(g2), outdir=split, niter=RNITER, resume=True)
    return whole, split, g


@pytest.mark.parametrize("which", ["array", "single ECORR"])
def test_resume_without_white_is_bitwise(which, tmp_path_factory):
    """Split at row 28 (a chunk boundary) and resumed: the chain files
    equal the whole run's bitwise.  The fixed-ECORR single pulsar has
    ECORR columns but no ECORR block."""
    from pulsar_timing_gibbsspec_torch import model_general

    assert (RSPLIT - RWARM - 1) % RCHUNK == 0
    if which == "array":
        psrs = small_psrs()
        opts, facade = ARRAY, "PTABlockGibbs"
    else:
        psrs = [nanograv_psr()]
        opts, facade = SINGLE, "PulsarBlockGibbs"
    cm = model_general(psrs, noisedict=synthetic_noisedict(psrs, 4),
                       device="cpu", **opts)
    whole, split, g = resume_runs(tmp_path_factory, facade, cm)
    if which != "array":
        assert cm.ec_cols.shape[1] == 107 and len(cm.idx.ecorr) == 0
    assert not {"white", "ecorr"} & set(g.driver.sweep_blocks(False))
    for nm in ("chain.npy", "bchain.npy"):
        assert np.array_equal(np.load(whole / nm), np.load(split / nm)), nm
    with np.load(split / "adapt.npz") as z:
        assert not set(z.files) & WHITE_KEYS
    assert np.isfinite(g.chain).all()
