"""The reference's complete single-pulsar sweep with the powerlaw hyper
block (R1), the port's ``PulsarBlockGibbs`` against the JAX package's on
the CPU: JSYN02 (flagged NANOGrav, basis ECORR), common free spectrum,
intrinsic powerlaw red noise, 4 bins.

Both run 8 chains from one start through 5 warmup sweeps, the
adaptation (200 marginalized-likelihood MH steps for the red block) and
75 steady sweeps.  For the red ``log10_A`` and ``gamma`` and every common
``log10_rho``, each chain's median over the steady rows is taken; chains
are independent, so the chain-to-chain spread gives the Monte-Carlo
standard error of the mean of those medians on each side, and the two
means agree within 5 combined standard errors (as
``test_torch_single.py`` (f)).  Also: the sweep's blocks and order, the
adaptation's shapes, ``b_param_names`` and ``chain_shapes`` against the
JAX facade, and the JAX package's ``integrity.verify`` on the port's
checkpoint with ``cov_red``/``red_hist`` in its ``adapt.npz``.
"""

import numpy as np
import pytest
import torch

from test_torch_cases import medians_agree, nanograv_psr, run_both

torch.set_num_threads(2)

C, WARM, NITER = 8, 5, 81


@pytest.fixture(scope="module")
def r1(tmp_path_factory):
    return run_both(tmp_path_factory, [nanograv_psr()], "PulsarBlockGibbs",
                    nchains=C, warmup=WARM, niter=NITER, white_adapt=120,
                    red_adapt=200, common_psd="spectrum",
                    common_components=4, red_psd="powerlaw",
                    red_components=4)


def test_r1_posterior_matches_jax(r1):
    """Red log10_A, gamma and every common log10_rho: the medians agree,
    inside their priors."""
    _, jchain, tg, tchain, _ = r1
    cm = tg.cm
    red = [int(j) for j in cm.idx.red]
    cols = red + cm.rho_ix_x.tolist()
    med = medians_agree(jchain, tchain, WARM + 1, cols,
                        [cm.param_names[j] for j in cols])
    assert np.all((med[len(red):] > -10) & (med[len(red):] < -4))
    for j, m in zip(red, med):
        assert float(cm.pa[j]) < m < float(cm.pb[j])


def test_r1_sweep_and_adaptation(r1):
    """R1 runs white, ECORR, the red powerlaw MH, rho by the grid draw,
    the scale moves and b, in the JAX order; the adaptation left a
    covariance and a seed history per chain; the red hypers move."""
    jg, _, tg, tchain, _ = r1
    drv = tg.driver
    assert drv.sweep_blocks(False) == ["white", "ecorr", "red_mh", "rho",
                                       "scale", "b_mh"]
    assert drv.timer.calls["red_mh"] == NITER - 1
    d = len(tg.cm.idx.red)
    assert drv.cov_red.shape == (C, d, d) and drv.red_hist.shape == (C, 64, d)
    assert np.asarray(jg._backend.cov_red).shape == drv.cov_red.shape
    assert drv.de_chain_periods == []          # the window opens at 384
    steady = tchain[WARM + 1:, :, tg.cm.idx.red]
    assert (steady.std(0) > 1e-3).all()
    assert np.isfinite(tchain).all() and np.isfinite(tg.bchain).all()


def test_r1_layout_matches_jax_facade(r1):
    """``b_param_names`` (the red powerlaw shares the Fourier columns,
    named after the common process) and ``chain_shapes`` equal the JAX
    facade's; the JAX package's ``integrity.verify`` accepts the port's
    checkpoint, whose ``adapt.npz`` carries ``cov_red`` and
    ``red_hist``."""
    from pulsar_timing_gibbsspec_tpu.runtime import integrity as jint

    jg, _, tg, _, out = r1
    assert tg.b_param_names == jg.b_param_names
    for niter in (1, 2, WARM + 1, WARM + 2, NITER):
        assert tg.driver.chain_shapes(niter) == \
            jg._backend.chain_shapes(niter), niter
    rep = jint.verify(out)
    assert rep["ok"] and rep["rows"] == NITER
    with np.load(out / "adapt.npz") as z:
        assert np.array_equal(z["cov_red"], tg.driver.cov_red)
        assert np.array_equal(z["red_hist"], tg.driver.red_hist)
