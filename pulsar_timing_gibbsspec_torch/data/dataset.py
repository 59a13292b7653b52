"""Host-side pulsar record.

Copies of the ``Pulsar`` record, ``get_tspan``, ``from_enterprise`` and
``load_enterprise_snapshot`` of ``pulsar_timing_gibbsspec_tpu/data/
dataset.py`` (the par/tim loaders are not part of the port yet).  A
pulsar keeps its per-TOA flag arrays in ``flags``; the ``pta`` flag is a
scalar label, which gates basis ECORR in the model builder.
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


def from_enterprise(epsr) -> Pulsar:
    """A :class:`Pulsar` from an ``enterprise.Pulsar`` attribute surface
    (``name``, ``toas`` [s], ``toaerrs`` [s], ``residuals`` [s],
    ``freqs`` [MHz], ``backend_flags``, ``Mmat``, ``fitpars``, ``flags``,
    ``pos``), duck-typed: any object with those attributes converts.
    Flags stay per-TOA arrays, except ``pta``, which becomes one scalar
    label (its first entry, ``""`` when empty or absent)."""
    toas = np.asarray(epsr.toas, dtype=np.float64)
    Mmat = np.asarray(epsr.Mmat, dtype=np.float64)
    if Mmat.ndim != 2 or Mmat.shape[0] != toas.shape[0]:
        raise ValueError(
            f"{epsr.name}: Mmat shape {Mmat.shape} does not match "
            f"{toas.shape[0]} TOAs")
    flags = {}
    for key, val in dict(getattr(epsr, "flags", {}) or {}).items():
        arr = np.asarray(val)
        if key == "pta":
            flags[key] = str(arr.flat[0]) if arr.size else ""
        else:
            flags[key] = arr
    flags.setdefault("pta", "")
    pos = np.asarray(getattr(epsr, "pos", np.zeros(3)), dtype=np.float64)
    return Pulsar(
        name=str(epsr.name),
        toas=toas,
        toaerrs=np.asarray(epsr.toaerrs, dtype=np.float64),
        residuals=np.asarray(epsr.residuals, dtype=np.float64),
        freqs=np.asarray(epsr.freqs, dtype=np.float64),
        backend_flags=np.asarray(epsr.backend_flags, dtype=object),
        Mmat=Mmat,
        fitpars=list(epsr.fitpars),
        flags=flags,
        pos=pos,
    )


def load_enterprise_snapshot(path) -> Pulsar:
    """Load a recorded ``enterprise.Pulsar`` attribute surface (an
    ``.npz`` with ``name``, ``toas``, ``toaerrs``, ``residuals``,
    ``freqs``, ``backend_flags``, ``Mmat``, ``fitpars``, ``pos`` and
    per-TOA ``flag_<name>`` arrays) through :func:`from_enterprise`."""
    import types

    with np.load(path, allow_pickle=False) as z:
        flags = {k[len("flag_"):]: z[k] for k in z.files
                 if k.startswith("flag_")}
        epsr = types.SimpleNamespace(
            name=str(z["name"]),
            toas=z["toas"],
            toaerrs=z["toaerrs"],
            residuals=z["residuals"],
            freqs=z["freqs"],
            backend_flags=z["backend_flags"].astype(object),
            Mmat=z["Mmat"],
            fitpars=[str(s) for s in z["fitpars"]],
            flags=flags,
            pos=z["pos"],
        )
    return from_enterprise(epsr)
