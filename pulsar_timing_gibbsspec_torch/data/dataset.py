"""Host-side pulsar record.

A copy of the ``Pulsar`` record and ``get_tspan`` of
``pulsar_timing_gibbsspec_tpu/data/dataset.py`` (the par/tim loaders are
not part of the port yet).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Pulsar:
    """Host-side per-pulsar data (all times/uncertainties in seconds)."""

    name: str
    toas: np.ndarray            # (n,) TOA epochs [s] (MJD * 86400)
    toaerrs: np.ndarray         # (n,) TOA uncertainties [s]
    residuals: np.ndarray       # (n,) timing residuals [s]
    freqs: np.ndarray           # (n,) observing frequency [MHz]
    backend_flags: np.ndarray   # (n,) backend/receiver label per TOA (str)
    Mmat: np.ndarray            # (n, m) timing design matrix
    fitpars: list               # fitted timing parameter names
    flags: dict = dataclasses.field(default_factory=dict)
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))

    @property
    def ntoa(self) -> int:
        return len(self.toas)

    def backends(self) -> list:
        return sorted(set(self.backend_flags.tolist()))


def get_tspan(psrs) -> float:
    """Common span [s] across pulsars (sets the grid ``f_i = i/Tspan``)."""
    tmin = min(p.toas.min() for p in psrs)
    tmax = max(p.toas.max() for p in psrs)
    return float(tmax - tmin)
