"""Shared cases of the PyTorch-port tests (imported by the other
``test_torch_*`` files), plus the checks of the synthetic array itself.

Every case is made from a seed with numpy and handed to both sides: the
JAX package's model comes from ``model_general`` + ``compile_pta`` on a
synthetic 3-pulsar array (<= 120 TOAs, 4 frequency bins), and the port
computes on that very model through ``from_arrays``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.data.simulate import (YEAR, powerlaw_psd,
                                                          synthetic_array)
from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays

torch.set_num_threads(2)

NBINS = 4


def small_psrs(seed=1):
    """3 synthetic pulsars with 71-120 TOAs and 1-3 backends."""
    return synthetic_array(npsr=3, seed=seed, ntoa_min=71, ntoa_max=120)


def jax_pta(psrs, nbins=NBINS, red_bins=NBINS):
    """The JAX package's model of ``psrs`` (the repo's headline model)."""
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    jp = [Pulsar(**dataclasses.asdict(p)) for p in psrs]
    return model_general(jp, tm_svd=True, white_vary=True,
                         common_psd="spectrum", common_components=nbins,
                         red_var=True, red_psd="spectrum",
                         red_components=red_bins)


def jax_compiled(psrs, nbins=NBINS, red_bins=NBINS, pad_pulsars=None):
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    return compile_pta(jax_pta(psrs, nbins, red_bins),
                       pad_pulsars=pad_pulsars)


def jax_fields(cm):
    """A JAX ``CompiledPTA``'s fields as numpy, components as dicts."""
    out = {}
    for f in dataclasses.fields(cm):
        v = getattr(cm, f.name)
        if f.name == "components":
            v = [{k: (getattr(c, k) if k == "kind"
                      else np.asarray(getattr(c, k)))
                  for k in ("kind", "cols", "f", "df", "hyp_ix", "rho_ix")}
                 for c in v]
        elif f.name == "idx":
            continue
        out[f.name] = v
    return out


def models(seed=1):
    """``(jax_cm, port_cm)``: one model on both sides."""
    cmj = jax_compiled(small_psrs(seed))
    return cmj, from_arrays(jax_fields(cmj), device="cpu")


def state(cm, C=None, seed=0):
    """A seeded state near the stationary region as numpy float64:
    efac in [0.8, 1.2], equad in [-8.5, -6.5], common log10_rho at the
    injected power law +-0.3 dex, red log10_rho in [-9, -8.5].  Shape
    (nx,), or (C, nx)."""
    rng = np.random.default_rng(seed)
    shape = (cm.nx,) if C is None else (C, cm.nx)
    u = rng.uniform(size=shape)
    x = np.zeros(shape)
    Tspan = 10.0 * YEAR
    for j, nm in enumerate(cm.param_names):
        if nm.endswith("_efac"):
            x[..., j] = 0.8 + 0.4 * u[..., j]
        elif nm.endswith("_log10_tnequad"):
            x[..., j] = -8.5 + 2.0 * u[..., j]
        elif "red_noise_log10_rho" in nm:
            x[..., j] = -9.0 + 0.5 * u[..., j]
        elif nm.startswith("gw_crn_log10_rho_"):
            k = int(nm.rsplit("_", 1)[1])
            phi = powerlaw_psd((k + 1) / Tspan, math.log10(2e-15),
                               13.0 / 3.0, 1.0 / Tspan)
            x[..., j] = 0.5 * math.log10(phi) + 0.6 * (u[..., j] - 0.5)
    return x


def t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def t32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def close(a, b, rtol, atol=0.0):
    """numpy assert_allclose on either side's arrays."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_synthetic_array_geometry():
    """The benchmark geometry: 45 pulsars, TOA counts log-spread over
    71-720, 1-4 backends, timing models of 8-17 columns, Bmax = 37."""
    from pulsar_timing_gibbsspec_torch.models.build import (
        crn_spectrum_arrays)

    psrs = synthetic_array(npsr=45, seed=0)
    counts = [p.ntoa for p in psrs]
    assert len(psrs) == 45 and counts[0] == 71 and counts[-1] == 720
    assert np.all(np.diff(counts) >= 0)
    assert {len(p.backends()) for p in psrs} == {1, 2, 3, 4}
    assert {p.Mmat.shape[1] for p in psrs} == set(range(8, 18))
    a = crn_spectrum_arrays(psrs)
    assert (a["P"], a["Nmax"], a["Bmax"]) == (45, 720, 37)
    assert all(np.isfinite(p.residuals).all() for p in psrs)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_array_is_seeded(seed):
    a, b = synthetic_array(npsr=4, seed=seed), synthetic_array(npsr=4,
                                                                seed=seed)
    for p, q in zip(a, b):
        assert np.array_equal(p.residuals, q.residuals)
        assert np.array_equal(p.toas, q.toas)
    c = synthetic_array(npsr=4, seed=seed + 1)
    assert not np.array_equal(a[0].residuals, c[0].residuals)
