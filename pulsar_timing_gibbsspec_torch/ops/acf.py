"""Integrated autocorrelation time (ACT), batched over columns.

The Sokal self-consistent-window estimator of
``pulsar_timing_gibbsspec_tpu/ops/acf.py`` (NumPy FFT form), applied to
many chains at once: it sizes the white-noise MH sub-chains of every
sweep after adaptation.
"""

from __future__ import annotations

import numpy as np


def act_from_rho(rho: np.ndarray, c: float = 5.0) -> np.ndarray:
    """Sokal windowed ACT from normalized autocorrelations ``rho``
    (..., L): ``tau(W) = 1 + 2 sum_{t<=W} rho_t`` at the first lag
    ``W >= c tau(W)`` (the full window when none qualifies), >= 1."""
    rho = np.asarray(rho, dtype=np.float64)
    tau = 2.0 * np.cumsum(rho, axis=-1) - 1.0
    windows = np.arange(rho.shape[-1])
    ok = windows >= c * tau
    w = np.argmax(ok, axis=-1)
    w = np.where(np.any(ok, axis=-1), w, rho.shape[-1] - 1)
    return np.maximum(np.take_along_axis(tau, w[..., None],
                                         axis=-1)[..., 0], 1.0)


def integrated_act_columns(x: np.ndarray, c: float = 5.0) -> np.ndarray:
    """ACT of every column of ``x`` (steps, ncols); constant columns and
    chains shorter than 4 steps give 1.0."""
    x = np.asarray(x, dtype=np.float64)
    n, k = x.shape
    if n < 4:
        return np.ones(k)
    d = x - x.mean(axis=0)
    nfft = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(d, nfft, axis=0)
    acf = np.fft.irfft(f * np.conj(f), nfft, axis=0)[:n].real
    out = np.ones(k)
    live = (np.ptp(x, axis=0) > 0) & (acf[0] > 0)
    if live.any():
        out[live] = act_from_rho((acf[:, live] / acf[0, live]).T, c)
    return out


def integrated_act(x: np.ndarray, c: float = 5.0) -> float:
    """Sokal windowed ACT of one chain (the NumPy FFT form of the JAX
    package's ``integrated_act``); chains shorter than 4 steps and
    constant ones give 1.0."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim != 1:
        raise ValueError("integrated_act expects a 1-d chain")
    return float(integrated_act_columns(x[:, None], c)[0])
