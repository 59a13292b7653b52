"""``model_general``'s frequency-grid and selection options: the port
against the JAX package on the CPU, on the same numpy inputs.

Checked:

- ``fourier_basis`` with ``pshift`` phases and explicit ``modes``
  bitwise against the JAX function, and the port's per-pulsar CRC32
  seed and phases against ``FourierGPSignal``'s;
- the arrays of the port's ``model_arrays`` equal ``jax_fields(
  compile_pta(model_general(...)))`` field by field, and the flat b
  names the JAX facade's, for ``Tspan``, ``modes``, ``logfreq`` /
  ``nmodes_log``, ``wgts``, ``pshift`` / ``pseed``, ``select`` of
  ``None`` and ``"none"``, ``tm_norm=False``, ``orf_names`` (with the
  common process sharing the red columns and under Hellings-Downs),
  ``red_select`` of ``"band"``, ``"band+"`` and ``"backend"`` on one
  pulsar, and ``chip_smoke.py`` phase 15's model (common and red free
  spectra on the log grid given as ``modes``, pshift), also with red
  powerlaw;
- several common processes: the JAX compiled model carries them all
  but samples the first alone (``rho_ix_x`` holds one process's
  indices), so the port refuses them;
- the port's ``PTABlockGibbs`` on phase 15's model shape (log grid,
  pshift) against the JAX facade's posterior.
"""

import zlib

import numpy as np
import pytest
import torch

from test_torch_cases import (jax_fields, medians_agree, nanograv_psr,
                              run_both, small_psrs)
from test_torch_noise import (BINS, NB, assert_same_model, case_psrs,
                              jax_pta, nd_ng, nd_small, port_arrays)

from pulsar_timing_gibbsspec_torch.data import fourier
from pulsar_timing_gibbsspec_torch.models.build import log_grid

torch.set_num_threads(2)

#: a span a little longer than the array's, and the log grid phase 15
#: passes as ``modes`` (``NB`` log-spaced bins below 1/T, ``NB`` linear)
TSPAN = 3.3e8
GRID = log_grid(NB, NB, TSPAN)
#: phase 15's model at the tests' size: common and red free spectra with
#: one bin per grid frequency (the JAX ``compile_pta`` cannot compile a
#: free spectrum under ``logfreq=True``: its size is ``common_components``
#: but the grid has ``nmodes_log`` more frequencies)
PHASE15 = dict(tm_svd=True, white_vary=True, Tspan=TSPAN, modes=GRID,
               common_psd="spectrum", common_components=2 * NB,
               red_psd="spectrum", red_components=2 * NB, pshift=True,
               pseed=1)

CASES = {
    "Tspan": ("small", dict(white_vary=True, Tspan=TSPAN)),
    "modes": ("small", dict(white_vary=True, common_psd="spectrum",
                            red_psd="spectrum",
                            modes=np.arange(1, NB + 1) / 3.1e8)),
    "logfreq": ("small", dict(white_vary=True, logfreq=True)),
    "logfreq nmodes_log Tspan": ("small", dict(
        white_vary=True, logfreq=True, nmodes_log=3, Tspan=TSPAN,
        dm_var=True)),
    "wgts": ("small", dict(white_vary=True, common_psd="spectrum",
                           wgts=np.linspace(1e-5, 4e-5, NB))),
    "pshift": ("small", dict(white_vary=True, pshift=True)),
    "pshift pseed, red wider": ("small", dict(
        noisedict=nd_small(), pshift=True, pseed=7, common_psd="spectrum",
        red_psd="spectrum", red_components=NB + 2, dm_var=True)),
    "select None": ("ng", dict(white_vary=True, select=None)),
    "select none, fixed": ("ng", dict(select="none", noisedict=nd_ng())),
    "tm_norm False": ("small", dict(white_vary=True, tm_norm=False)),
    "orf_names": ("small", dict(white_vary=True, common_psd="spectrum",
                                orf_names="gwb")),
    "orf_names hd": ("small", dict(tm_svd=True, white_vary=True,
                                   common_psd="spectrum", red_psd="spectrum",
                                   orf="hd", orf_names="gwb")),
    "red_select band": ("ng", dict(white_vary=True, red_select="band")),
    "red_select band+ wgts": ("ng", dict(
        white_vary=True, red_select="band+", wgts=np.full(NB, 2e-5),
        upper_limit_red=True)),
    "red_select backend": ("ng", dict(noisedict=nd_ng(),
                                      red_select="backend", dm_var=True)),
    "phase 15": ("small", PHASE15),
    "log grid as modes, red powerlaw": ("small", dict(PHASE15,
                                                      red_psd="powerlaw")),
}


def test_fourier_basis_with_phases_matches_jax():
    """``fourier_basis`` with explicit ``modes`` and ``pshift`` phases
    equals the JAX function bitwise; the per-pulsar seed is the JAX
    factory's CRC32 and the phases its ``default_rng`` draw, a narrower
    signal taking a prefix of a wider one's."""
    from pulsar_timing_gibbsspec_tpu.data.fourier import \
        fourier_basis as jax_basis

    p = small_psrs()[1]
    seed = fourier.pshift_seed(3, p.name)
    assert seed == zlib.crc32(repr((3, p.name)).encode())
    assert fourier.pshift_seed(None, p.name) == fourier.pshift_seed(
        0, p.name)
    ph = fourier.pshift_phases(seed, len(GRID))
    assert np.array_equal(ph, np.random.default_rng(seed).uniform(
        0.0, 2.0 * np.pi, len(GRID)))
    assert np.array_equal(fourier.pshift_phases(seed, 3), ph[:3])
    for kw in (dict(), dict(modes=GRID), dict(pshift_phases=ph[:NB]),
               dict(modes=GRID, pshift_phases=ph)):
        got = fourier.fourier_basis(p.toas / 86400.0, NB, TSPAN, **kw)
        want = jax_basis(p.toas / 86400.0, NB, TSPAN, **kw)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), kw
    assert np.array_equal(GRID[NB:], np.arange(1, NB + 1) / TSPAN)


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_equals_compile_pta(name):
    """The port's arrays equal ``compile_pta``'s field by field (T with
    the phases, masks and grid; f, df and the weights; the index tables;
    the constant pool) and the flat b names are the JAX facade's."""
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import PTABlockGibbs

    which, opts = CASES[name]
    psrs = case_psrs(which)
    kw = dict(BINS, **opts)
    pta = jax_pta(psrs, **kw)
    got = port_arrays(psrs, **kw)
    assert_same_model(jax_fields(compile_pta(pta)), got, pta)
    jg = PTABlockGibbs.__new__(PTABlockGibbs)
    jg.pta, jg.ecorrsample = pta, None
    assert list(got["b_names"]) == jg.b_param_names


def test_grid_shapes():
    """What the options do to the model: the log grid adds ``nmodes_log``
    frequencies to K (4 + 10 = 14, Bmax 38 on the small array), a band
    split puts two row-masked red GPs on columns of their own, with
    their hypers among the powerlaw block's, and ``orf_names`` renames
    the common parameters."""
    from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays

    a = port_arrays(small_psrs(), white_vary=True, logfreq=True, **BINS)
    assert (a["K"], a["Kr"], a["Bmax"]) == (NB + 10, NB + 10, 38)
    assert np.all(np.diff(a["gw_f"][0]) > 0)
    p = nanograv_psr()
    b = port_arrays([p], white_vary=True, red_select="band", **BINS)
    assert b["red_kind"] == "" and not b["red_valid"].any()
    kinds = [c["kind"] for c in b["components"]]
    assert kinds == ["powerlaw", "powerlaw", "powerlaw", "ecorr"]
    T = b["T"][0, :p.ntoa]
    # groups in label order: "high" (above 1 GHz), then "low"
    for c, band in zip(b["components"][1:3], (p.freqs > 1000.0,
                                              p.freqs <= 1000.0)):
        cols = c["cols"][0]
        assert np.all(T[~band][:, cols] == 0) and np.any(T[band][:, cols])
    cm = from_arrays(b, device="cpu")
    assert [cm.param_names[j] for j in cm.idx.red] == [
        f"{p.name}_red_noise_{lab}_{h}" for lab in ("high", "low")
        for h in ("gamma", "log10_A")] + ["gw_crn_gamma", "gw_crn_log10_A"]
    n = port_arrays(small_psrs(), white_vary=True, common_psd="spectrum",
                    orf_names="gwb", **BINS)["param_names"]
    assert [x for x in n if x.startswith("gw_")] == [
        f"gw_gwb_log10_rho_{k}" for k in range(NB)]


def test_several_common_processes_are_refused():
    """``orf="crn,crn"``: the JAX compiled model has 8 common log10_rho
    parameters but ``rho_ix_x`` indexes the first process's 4, so its
    sampler never moves the second; the port raises
    ``NotImplementedError`` saying so."""
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    opts = dict(BINS, white_vary=True, orf="crn,crn", orf_names="crn,crn2",
                common_psd="spectrum")
    pta = jax_pta(small_psrs(), **opts)
    cmj = compile_pta(pta)
    rho = [n for n in pta.param_names
           if n.startswith("gw_") and "_log10_rho_" in n]
    assert len(rho) == 2 * NB and len(cmj.rho_ix_x) == NB
    assert [pta.param_names[j] for j in np.asarray(cmj.rho_ix_x)] == [
        f"gw_crn_log10_rho_{k}" for k in range(NB)]
    with pytest.raises(NotImplementedError, match="samples only the first"):
        port_arrays(small_psrs(), **opts)


def test_logfreq_pshift_posterior_matches_jax(tmp_path_factory):
    """Phase 15's model on the small array (common and red free spectra
    on the log grid, pshift): ``PTABlockGibbs``
    on both sides, 4 chains, 3 warmup + 40 steady sweeps; each common
    log10_rho's mean over chains of the per-chain medians agrees within
    5 combined standard errors, inside the prior."""
    _, jchain, tg, tchain, _ = run_both(
        tmp_path_factory, small_psrs(), "PTABlockGibbs", nchains=4,
        warmup=3, niter=44, white_adapt=120, red_adapt=0, **PHASE15)
    cm = tg.cm
    assert tg.driver.sweep_blocks(False) == ["white", "red", "rho", "scale",
                                             "b_mh"]
    cols = cm.rho_ix_x.tolist()
    med = medians_agree(jchain, tchain, 4, cols,
                        [cm.param_names[j] for j in cols])
    assert np.all((med > -10) & (med < -4))
