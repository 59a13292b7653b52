"""Fourier (rank-reduced GP) basis.

A copy of ``pulsar_timing_gibbsspec_tpu/data/fourier.py``: sin/cos pairs
at ``f_j = j / Tspan``, interleaved ``[sin f_1, cos f_1, sin f_2, ...]``
so the sampler's pairwise folds over ``[::2]`` / ``[1::2]`` strides hold.
"""

from __future__ import annotations

import numpy as np

DAY = 86400.0


def fourier_basis(toas_mjd: np.ndarray, nmodes: int, Tspan: float,
                  modes: np.ndarray | None = None):
    """Return ``(F, f)``: basis (n, 2*nmodes) and per-column frequencies.

    ``toas_mjd`` are TOA epochs in MJD, ``Tspan`` the span in seconds
    defining the fundamental ``1/Tspan``; ``modes`` optionally lists the
    frequencies [Hz] explicitly.
    """
    t = toas_mjd * DAY
    if modes is None:
        f = np.arange(1, nmodes + 1) / Tspan
    else:
        f = np.asarray(modes, dtype=np.float64)
        nmodes = len(f)
    F = np.zeros((len(t), 2 * nmodes))
    arg = 2.0 * np.pi * t[:, None] * f[None, :]
    F[:, ::2] = np.sin(arg)
    F[:, 1::2] = np.cos(arg)
    return F, np.repeat(f, 2)
