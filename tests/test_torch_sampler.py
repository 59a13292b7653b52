"""The whole sampler: the port's ``PTABlockGibbs`` against the JAX
package's on the same 3-pulsar CRN free-spectrum model.

Both run 8 chains through warmup, adaptation and steady sweeps from the
same start.  Per frequency bin, each chain's median of the common
log10_rho over the steady rows is taken; chains are independent, so the
chain-to-chain spread gives the Monte-Carlo standard error of the mean
of those medians on each side.  The two means must agree within 5
combined standard errors (``sqrt(se_jax^2 + se_port^2)``).
"""

import numpy as np
import pytest
import torch

from test_torch_cases import jax_pta, small_psrs

torch.set_num_threads(2)

C, WARM, NITER, ADAPT = 8, 5, 121, 150


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from pulsar_timing_gibbsspec_torch import (PTABlockGibbs,
                                               build_crn_spectrum)
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import \
        PTABlockGibbs as JaxGibbs

    psrs = small_psrs()
    pta = jax_pta(psrs)
    x0 = pta.initial_sample(np.random.default_rng(0))
    jg = JaxGibbs(pta, backend="jax", nchains=C, seed=0, progress=False,
                  warmup_sweeps=WARM, white_adapt_iters=ADAPT,
                  chunk_size=NITER - WARM - 1)
    jchain = jg.sample(x0, outdir=str(tmp_path_factory.mktemp("jax")),
                       niter=NITER)
    cm = build_crn_spectrum(psrs, 4, 4, device="cpu")
    assert list(cm.param_names) == list(pta.param_names)
    tg = PTABlockGibbs(cm, nchains=C, device="cpu", seed=0,
                       warmup_sweeps=WARM, white_adapt_iters=ADAPT)
    out = tmp_path_factory.mktemp("torch")
    tchain = tg.sample(x0, outdir=str(out), niter=NITER)
    return jchain, tg, tchain, out, jg._backend.aclength_white


def _chain_medians(chain, cols):
    steady = chain[WARM + 1:][:, :, cols]            # (rows, C, K)
    med = np.median(steady, axis=0)                  # (C, K)
    return med.mean(0), med.std(0, ddof=1) / np.sqrt(med.shape[0])


def test_common_spectrum_posterior_matches_jax(runs):
    jchain, tg, tchain, _, _ = runs
    cols = tg.cm.rho_ix_x.numpy()
    mj, sj = _chain_medians(jchain, cols)
    mt, st = _chain_medians(tchain, cols)
    z = np.abs(mj - mt) / np.sqrt(sj ** 2 + st ** 2)
    assert np.all(z <= 5.0), (mj, mt, z)
    assert np.all((mt > -10) & (mt < -4))


def test_chain_files_and_layout(runs):
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    _, tg, tchain, out, _ = runs
    cm = tg.cm
    assert tchain.shape == (NITER, C, cm.nx)
    assert tg.bchain.shape == (NITER, C, sum(cm.widths))
    assert np.isfinite(tchain).all() and np.isfinite(tg.bchain).all()
    assert np.array_equal(np.load(out / "chain.npy"), tchain)
    assert np.array_equal(np.load(out / "bchain.npy"), tg.bchain)
    names = (out / "pars_chain.txt").read_text().split()
    assert names == list(cm.param_names)
    bnames = (out / "pars_bchain.txt").read_text().split()
    assert bnames == cm.b_param_names() and len(bnames) == sum(cm.widths)
    rep = integrity.verify(out)
    assert rep["ok"] and rep["rows"] == NITER
    with np.load(out / "adapt.npz") as z:
        assert np.array_equal(z["x_cur"], tg.driver.x_cur)
        assert int(z["it_cur"]) == NITER
    # rows 0..WARM-1 are warmup states, row WARM the post-warmup state:
    # chains diverge from the shared start
    assert np.ptp(tchain[0], axis=0).max() == 0.0
    assert np.ptp(tchain[-1], axis=0).max() > 0.0


def test_sweep_schedule(runs):
    """Steady iterations t = WARM+1 .. NITER-1 take the refresh b-draw
    exactly when t % exact_every == 0, and the steady Metropolised draw
    otherwise; every block ran on every sweep.  The adaptation sizes the
    white sub-chain like the JAX package's (within 2x: both measure an
    ACT percentile of their own random adaptation records)."""
    _, tg, _, _, jax_white = runs
    drv = tg.driver
    steady = range(WARM + 1, NITER)
    n_ref = sum(t % drv.exact_every == 0 for t in steady)
    assert drv.steady_sweeps == len(steady)
    assert drv.timer.calls["b_refresh"] == WARM + n_ref
    assert drv.timer.calls["b_mh"] == drv.b_mh_sweeps == len(steady) - n_ref
    for blk in ("white", "red", "rho", "scale"):
        assert drv.timer.calls[blk] == WARM + len(steady)
    acc = (drv.b_mh_accepts / drv.b_mh_sweeps).numpy()
    assert acc.mean() > 0.9
    assert 1 <= drv.aclength_white <= drv.white_steps_max
    assert jax_white / 2 <= drv.aclength_white <= 2 * jax_white


def test_act_estimator_matches_jax():
    """The batched ACT estimator that sizes the white sub-chain equals
    the JAX package's per-chain NumPy estimator."""
    from pulsar_timing_gibbsspec_torch.ops.acf import integrated_act_columns
    from pulsar_timing_gibbsspec_tpu.ops import acf as jacf

    rng = np.random.default_rng(0)
    e = rng.standard_normal((400, 5))
    cols = np.empty_like(e)
    cols[0] = e[0]
    for t in range(1, 400):                        # AR(1), phi = 0.8
        cols[t] = 0.8 * cols[t - 1] + e[t]
    cols[:, 3] = 1.0                               # a frozen coordinate
    got = integrated_act_columns(cols)
    ref = [float(jacf.act_from_rho(jacf._autocorr_fft(cols[:, k])))
           if np.ptp(cols[:, k]) > 0 else 1.0 for k in range(5)]
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert got[3] == 1.0 and got[0] > 3.0
