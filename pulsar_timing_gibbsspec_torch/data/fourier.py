"""Fourier (rank-reduced GP) basis.

A copy of ``pulsar_timing_gibbsspec_tpu/data/fourier.py``: sin/cos pairs
at ``f_j = j / Tspan``, interleaved ``[sin f_1, cos f_1, sin f_2, ...]``
so the sampler's pairwise folds over ``[::2]`` / ``[1::2]`` strides hold;
plus the per-pulsar random phases of ``model_general(pshift=True)``
(``models/signals.py::FourierGPSignal`` and ``models/factory.py`` of the
JAX package draw them inline).
"""

from __future__ import annotations

import zlib

import numpy as np

DAY = 86400.0


def pshift_seed(pseed, psr_name: str) -> int:
    """The per-pulsar seed of ``pshift``: CRC32 of ``repr((pseed or 0,
    name))``, stable across interpreter runs (``hash()`` is not)."""
    return zlib.crc32(repr((pseed or 0, psr_name)).encode())


def pshift_phases(seed: int, nmodes: int) -> np.ndarray:
    """``nmodes`` phases uniform on ``[0, 2 pi)`` from ``seed``; a signal
    with fewer modes takes a prefix of a wider one's."""
    return np.random.default_rng(seed).uniform(0.0, 2.0 * np.pi, nmodes)


def fourier_basis(toas_mjd: np.ndarray, nmodes: int, Tspan: float,
                  modes: np.ndarray | None = None,
                  pshift_phases: np.ndarray | None = None):
    """Return ``(F, f)``: basis (n, 2*nmodes) and per-column frequencies.

    ``toas_mjd`` are TOA epochs in MJD, ``Tspan`` the span in seconds
    defining the fundamental ``1/Tspan``; ``modes`` optionally lists the
    frequencies [Hz] explicitly; ``pshift_phases`` [rad], one per
    frequency, are added inside the sin/cos arguments (sky-scramble and
    false-alarm studies).
    """
    t = toas_mjd * DAY
    if modes is None:
        f = np.arange(1, nmodes + 1) / Tspan
    else:
        f = np.asarray(modes, dtype=np.float64)
        nmodes = len(f)
    F = np.zeros((len(t), 2 * nmodes))
    arg = 2.0 * np.pi * t[:, None] * f[None, :]
    if pshift_phases is not None:
        arg = arg + np.asarray(pshift_phases, dtype=np.float64)[None, :]
    F[:, ::2] = np.sin(arg)
    F[:, 1::2] = np.cos(arg)
    return F, np.repeat(f, 2)
