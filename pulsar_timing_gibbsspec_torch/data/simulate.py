"""Injection simulator and the synthetic pulsar array of the port.

``powerlaw_psd``, ``inject_residuals`` and ``_postfit_project`` are
copies of ``pulsar_timing_gibbsspec_tpu/data/simulate.py``: Fourier
coefficients drawn from a power-law PSD plus white measurement noise,
with the timing-model column space projected out ("post-fit").

:func:`synthetic_array` builds a pulsar array with the geometry of the
45-pulsar benchmark set from a seed alone: TOA counts log-spread over
71-720, 1-4 backends per pulsar, timing models of 8-17 columns (so the
CRN basis is Bmax = 17 + 2*nbins wide) and an injected common power law.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .dataset import Pulsar
from .fourier import fourier_basis

DAY = 86400.0
YEAR = 365.25 * DAY
FYR = 1.0 / YEAR

#: centre frequencies [MHz] of the synthetic backends, in order of use
_BACKEND_MHZ = (1400.0, 820.0, 2300.0, 430.0)


def powerlaw_psd(f: np.ndarray, log10_A: float, gamma: float,
                 df: float) -> np.ndarray:
    """Per-coefficient prior variance of the Fourier modes [s^2]:
    ``phi(f) = A^2/(12 pi^2) fyr^(gamma-3) f^(-gamma) df``."""
    A = 10.0 ** log10_A
    return ((A**2 / (12.0 * np.pi**2)) * FYR ** (gamma - 3.0)
            * f ** (-gamma) * df)


def _stable_seed(name: str, salt: int) -> int:
    h = hashlib.sha256(f"{name}:{salt}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def inject_residuals(name, F, f, Tspan, toaerrs, Mmat,
                     log10_A=np.log10(2e-15), gamma=13.0 / 3.0,
                     efac=1.0, seed=0):
    """Post-fit residuals ``P_M^perp (F a + white noise)``; returns
    ``(residuals [s], injected coefficients a)``."""
    rng = np.random.default_rng(_stable_seed(name, seed))
    phi = powerlaw_psd(f, log10_A, gamma, 1.0 / Tspan)
    a = rng.normal(size=F.shape[1]) * np.sqrt(phi)
    noise = rng.normal(size=F.shape[0]) * toaerrs * efac
    return _postfit_project(Mmat, F @ a + noise), a


def _postfit_project(Mmat, r):
    """Subtract the least-squares timing-model fit through an
    orthonormalized column basis."""
    Q, _ = np.linalg.qr(Mmat / np.linalg.norm(Mmat, axis=0))
    return r - Q @ (Q.T @ r)


def _design(t, tau, nu, pb_days, ntm):
    """The first ``ntm`` of 17 timing-model columns: spin (offset, F0,
    F1), astrometry (annual terms and their proper-motion drift), DM
    (nu^-2 times a quadratic) and binary (orbital harmonics)."""
    w = 2.0 * np.pi / YEAR
    wb = 2.0 * np.pi / (pb_days * DAY)
    inv2 = (1400.0 / nu) ** 2
    cols = [np.ones_like(t), tau, tau * tau,
            np.sin(w * t), np.cos(w * t),
            tau * np.sin(w * t), tau * np.cos(w * t),
            inv2, tau * inv2, tau * tau * inv2,
            np.sin(2.0 * w * t), np.cos(2.0 * w * t),
            np.sin(wb * t), np.cos(wb * t),
            tau * np.sin(wb * t), tau * np.cos(wb * t),
            np.sin(2.0 * wb * t)]
    return np.column_stack(cols[:ntm])


def synthetic_array(npsr: int = 45, seed: int = 0, ntoa_min: int = 71,
                    ntoa_max: int = 720, log10_A: float = np.log10(2e-15),
                    gamma: float = 13.0 / 3.0, nmodes_inject: int = 30):
    """A seeded synthetic pulsar array with the benchmark geometry.

    Pulsar ``i`` has ``round(geomspace(ntoa_min, ntoa_max))[i]`` TOAs over
    a 4-15 yr span ending at MJD 58000, ``1 + i % 4`` backends (each TOA
    at its backend's centre frequency +-10%), ``8 + i % 10`` timing-model
    columns, and residuals carrying an injected common power law
    (``log10_A``, ``gamma``) drawn with :func:`inject_residuals`.
    """
    rng = np.random.default_rng(seed)
    counts = np.round(np.geomspace(ntoa_min, ntoa_max, npsr)).astype(int)
    psrs = []
    for i in range(npsr):
        n = int(counts[i])
        span = rng.uniform(4.0, 15.0) * YEAR
        t_end = 58000.0 * DAY
        toas = np.sort(rng.uniform(t_end - span, t_end, n))
        nb = 1 + i % 4
        labels = np.array([f"be{k}" for k in range(nb)], dtype=object)
        which = rng.permutation(np.arange(n) % nb)
        back = labels[which]
        centre = np.asarray(_BACKEND_MHZ)[which]
        nu = centre * rng.uniform(0.9, 1.1, n)
        base = 10.0 ** rng.uniform(-7.0, -5.7, nb)
        errs = base[which] * np.exp(0.2 * rng.standard_normal(n))
        tau = (toas - toas.mean()) / span
        M = _design(toas, tau, nu, rng.uniform(1.0, 30.0), 8 + i % 10)
        name = f"JSYN{i:02d}"
        Tp = float(toas.max() - toas.min())
        F, f = fourier_basis(toas / DAY, nmodes_inject, Tp)
        res, _ = inject_residuals(name, F, f, Tp, errs, M,
                                  log10_A=log10_A, gamma=gamma, seed=seed)
        v = rng.standard_normal(3)
        psrs.append(Pulsar(
            name=name, toas=toas, toaerrs=errs, residuals=res, freqs=nu,
            backend_flags=back, Mmat=M,
            fitpars=[f"tm{k}" for k in range(M.shape[1])],
            flags={"pta": ""}, pos=v / np.linalg.norm(v)))
    return psrs
