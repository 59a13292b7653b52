"""The powerlaw hyper block on the array, and the port's resume,
refusals and checkpoints for models that carry it (CPU).

- Posterior, R2 (the array model of ``bench.py::build_pta`` with powerlaw
  red in place of the red spectrum, the 3 pulsars of ``small_psrs``, 4
  bins): ``PTABlockGibbs`` on both sides, 8 chains from one start, 5
  warmup sweeps, the adaptation, 75 steady sweeps; every red
  ``log10_A``/``gamma`` and common ``log10_rho``: the means over chains of
  the chains' steady medians agree within 5 combined Monte-Carlo standard
  errors (the chains' spread).
- Resume: a 2-chain run of 420 iterations on the smallest case (one
  pulsar of 71 TOAs and one backend; common and red powerlaw; 5 red MH
  steps per sweep), split after iteration 384 at a chunk boundary off
  the 128-grid (row 388) and resumed in a fresh sampler, equals the
  whole run bitwise; all three runs read DE period 3 from chain rows.
- ``adapt.npz`` carries ``cov_red`` and ``red_hist``; a checkpoint
  without either is refused.  ``record_every > 1`` and ``chunk_size >
  DE_DELAY - DE_Q`` raise the JAX driver's errors.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_cases import medians_agree, run_both, small_psrs

torch.set_num_threads(2)

NB = 4
#: the resume case: chains, warmup, chunk, whole run, split row
RC, RWARM, RCHUNK, RNITER, RSPLIT = 2, 3, 16, 420, 388


def test_r2_posterior_matches_jax(tmp_path_factory):
    """R2: every red log10_A and gamma and every common log10_rho."""
    C, WARM, NITER = 8, 5, 81
    _, jchain, tg, tchain, _ = run_both(
        tmp_path_factory, small_psrs(), "PTABlockGibbs", nchains=C,
        warmup=WARM, niter=NITER, white_adapt=120, red_adapt=200,
        tm_svd=True, common_psd="spectrum", common_components=NB,
        red_psd="powerlaw", red_components=NB)
    cm = tg.cm
    assert len(cm.idx.red) == 6
    cols = [int(j) for j in cm.idx.red] + cm.rho_ix_x.tolist()
    medians_agree(jchain, tchain, WARM + 1, cols,
                  [cm.param_names[j] for j in cols])
    assert tg.driver.sweep_blocks(False) == ["white", "red_mh", "rho",
                                             "scale", "b_mh"]
    assert np.isfinite(tchain).all()


def _smallest():
    from pulsar_timing_gibbsspec_torch import model_general

    return model_general([small_psrs()[0]], white_vary=True,
                         common_components=NB, red_components=NB,
                         device="cpu")


@pytest.fixture(scope="module")
def resume_case(tmp_path_factory):
    from pulsar_timing_gibbsspec_torch import PulsarBlockGibbs

    cm = _smallest()

    def gibbs():
        return PulsarBlockGibbs(cm, nchains=RC, device="cpu", seed=0,
                                warmup_sweeps=RWARM, white_adapt_iters=60,
                                red_adapt_iters=120, red_steps=5,
                                chunk_size=RCHUNK)

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
    return cm, g, g1, g2, whole, split, gibbs


def test_resume_across_a_de_refresh_is_bitwise(resume_case):
    """Split after iteration 384 (row 388, a chunk boundary off the
    128-grid) and resumed: the chain files equal the whole run's bitwise;
    each run read DE period 3 from chain rows (the resumed one from the
    rows it preloaded)."""
    cm, g, g1, g2, whole, split, _ = resume_case
    assert RSPLIT > 384 and RSPLIT % 128 and (RSPLIT - RWARM - 1) % RCHUNK \
        == 0
    assert g.driver.sweep_blocks(False) == ["white", "red_mh", "b_mh"]
    for nm in ("chain.npy", "bchain.npy"):
        assert np.array_equal(np.load(whole / nm), np.load(split / nm)), nm
    for run in (g, g1, g2):
        assert run.driver.de_chain_periods == [3]
    assert np.array_equal(g.driver.red_hist, g2.driver.red_hist)
    assert np.isfinite(g.chain).all()


def test_checkpoint_without_red_adaptation_is_refused(resume_case):
    """``adapt.npz`` holds ``cov_red`` (C, d, d) and ``red_hist`` (C, 64,
    d); a checkpoint missing either is refused."""
    cm, _, _, _, whole, _, gibbs = resume_case
    d = len(cm.idx.red)
    with np.load(whole / "adapt.npz") as z:
        state = dict(z)
    assert state["cov_red"].shape == (RC, d, d)
    assert state["red_hist"].shape == (RC, 64, d)
    for key in ("cov_red", "red_hist"):
        cut = {k: v for k, v in state.items() if k != key}
        with pytest.raises(RuntimeError, match="red-block adaptation"):
            gibbs().driver.load_adapt_state(cut)


@pytest.mark.parametrize("opts, match", [
    (dict(record_every=2, chunk_size=100), "record_every > 1 is unavailable"),
    (dict(chunk_size=129), "exceeds the DE history delay margin")])
def test_red_mh_refusals_match_jax(opts, match):
    """Thinned records and chunks longer than DE_DELAY - DE_Q are refused
    with the JAX driver's message."""
    from pulsar_timing_gibbsspec_torch import PulsarBlockGibbs
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.jax_backend import \
        JaxGibbsDriver

    p = small_psrs()[0]
    pta = model_general([Pulsar(**dataclasses.asdict(p))], white_vary=True,
                        common_components=NB, red_components=NB)
    with pytest.raises(ValueError, match=match) as theirs:
        JaxGibbsDriver(pta, **opts)
    with pytest.raises(ValueError, match=match) as ours:
        PulsarBlockGibbs(_smallest(), device="cpu", **opts)
    assert str(ours.value) == str(theirs.value)
