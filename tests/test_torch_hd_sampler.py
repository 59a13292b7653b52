"""The Hellings-Downs array sampled: the port's ``PTABlockGibbs`` against
the JAX package's on the CPU, and the port's resume.

``bench.py``'s HD model (common free spectrum under the Hellings-Downs
ORF on columns of its own, per-pulsar red free spectrum) on the 3
synthetic pulsars of ``small_psrs``, 4 bins.  Both packages run 8 chains
from one start through 5 warmup sweeps, the adaptation and 75 steady
sweeps (the joint b-draw in two-float, float64 on every 16th).  For
every common and red log10_rho, each chain's median over the steady
rows is taken, and the two means over chains agree within 5 combined
standard errors (``medians_agree``, as in ``test_torch_red_sampler.py``).
Also: the sweep's blocks, ``b_param_names`` and ``chain_shapes`` against
the JAX facade, the JAX package's ``integrity.verify`` on the port's
checkpoint, and a run split at a chunk boundary and resumed, bitwise
equal to the whole run across refresh sweeps.
"""

import numpy as np
import pytest
import torch

from test_torch_cases import medians_agree, run_both, small_psrs

torch.set_num_threads(2)

C, WARM, NITER = 8, 5, 81
HD = dict(tm_svd=True, common_psd="spectrum", common_components=4,
          red_var=True, red_psd="spectrum", red_components=4, orf="hd")


@pytest.fixture(scope="module")
def hd(tmp_path_factory):
    return run_both(tmp_path_factory, small_psrs(), "PTABlockGibbs",
                    nchains=C, warmup=WARM, niter=NITER, white_adapt=120,
                    red_adapt=200, **HD)


def test_hd_posterior_matches_jax(hd):
    """Every common and red log10_rho: the medians agree, the common
    ones inside the prior (-10, -4); every record is finite."""
    _, jchain, tg, tchain, _ = hd
    cm = tg.cm
    cols = cm.rho_ix_x.tolist() + [int(j) for j in cm.idx.red_rho]
    med = medians_agree(jchain, tchain, WARM + 1, cols,
                        [cm.param_names[j] for j in cols])
    assert np.all((med[:cm.K] > -10) & (med[:cm.K] < -4))
    assert np.isfinite(tchain).all() and np.isfinite(tg.bchain).all()


def test_hd_sweep_and_layout(hd):
    """The sweep runs white, red, rho and the joint b-draw (no scale
    moves), the float64 joint draw on every 16th iteration and in the
    warmup; no chain kept its b; ``b_param_names`` and ``chain_shapes``
    equal the JAX facade's; JAX's ``integrity.verify`` accepts the
    port's checkpoint."""
    from pulsar_timing_gibbsspec_tpu.runtime import integrity as jint

    jg, _, tg, _, out = hd
    drv = tg.driver
    assert drv.sweep_blocks(False) == ["white", "red", "rho", "b_joint"]
    assert drv.sweep_blocks(True) == ["white", "red", "rho",
                                      "b_joint_exact"]
    steady = NITER - WARM - 1
    assert drv.timer.calls["b_joint_exact"] == WARM + 5   # 16 .. 80
    assert drv.timer.calls["b_joint"] == steady - 5
    assert drv.b_joint_breakdowns.tolist() == [0, 0]
    assert drv.warmup_breakdowns == [0, 0]
    assert tg.b_param_names == jg.b_param_names
    for niter in (1, 2, WARM + 1, WARM + 2, NITER):
        assert drv.chain_shapes(niter) == jg._backend.chain_shapes(niter)
    rep = jint.verify(out)
    assert rep["ok"] and rep["rows"] == NITER


@pytest.mark.parametrize("joint_mixed", [True, False])
def test_hd_resume_bitwise(tmp_path, joint_mixed):
    """2 chains, 3 warmup and 40 steady sweeps in chunks of 8: a run
    split at row 20 and resumed in a fresh sampler writes ``chain.npy``
    and ``bchain.npy`` bitwise equal to the whole run's (refresh sweeps
    at 16 and 32 on both sides), two-float or float64."""
    import pulsar_timing_gibbsspec_torch as ptt

    cm = ptt.model_general(small_psrs(), white_vary=True, device="cpu",
                           **HD)
    niter = 3 + 1 + 40

    def gibbs():
        return ptt.PTABlockGibbs(cm, nchains=2, device="cpu", seed=3,
                                 warmup_sweeps=3, white_adapt_iters=60,
                                 chunk_size=8, joint_mixed=joint_mixed)

    x0 = gibbs().initial_sample(torch.Generator().manual_seed(1))
    gibbs().sample(x0, outdir=tmp_path / "whole", niter=niter)
    gibbs().sample(x0, outdir=tmp_path / "split", niter=20)
    g = gibbs()
    g.sample(x0, outdir=tmp_path / "split", niter=niter, resume=True)
    assert g.driver.joint_mixed is joint_mixed
    for nm in ("chain.npy", "bchain.npy"):
        a = np.load(tmp_path / "whole" / nm)
        assert np.isfinite(a).all()
        assert np.array_equal(a, np.load(tmp_path / "split" / nm)), nm
