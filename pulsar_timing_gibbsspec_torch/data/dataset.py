"""Host-side pulsar record and its loaders.

Copies of the ``Pulsar`` record, ``get_tspan``, the par/tim loaders
(``load_pulsar``, ``load_directory``), ``from_enterprise`` and
``load_enterprise_snapshot`` of ``pulsar_timing_gibbsspec_tpu/data/
dataset.py``.  A pulsar keeps its flags in ``flags``; the ``pta`` flag
is a scalar label, which gates basis ECORR in the model builder.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .design import design_matrix
from .partim import parse_par, parse_tim

DAY = 86400.0


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


def _backend_labels(tim) -> np.ndarray:
    """Backend label per TOA: the ``-f`` flag if present (NANOGrav
    convention), else ``-be``, else the site code."""
    out = []
    for fl, site in zip(tim.flags, tim.sites):
        out.append(fl.get("f", fl.get("be", site)))
    return np.asarray(out, dtype=object)


def load_pulsar(par_path, tim_path, inject: dict | None = None) -> Pulsar:
    """Load one pulsar from par/tim: TOAs in seconds (MJD * 86400),
    uncertainties, frequencies, backend labels, the design matrix of the
    par file's fitted parameters (:func:`~.design.design_matrix`) and
    the unit vector to the pulsar (ecliptic coordinates rotated into the
    equatorial frame).

    Residuals are zero unless ``inject`` (keyword arguments of
    :func:`~.simulate.inject_residuals`, with ``nmodes`` (30) and
    ``Tspan`` (the TOAs' span) for its Fourier basis) regenerates them
    with a known red-noise injection, e.g. ``dict(log10_A=np.log10(2e-15),
    gamma=13/3, nmodes=30)``."""
    par = parse_par(par_path)
    tim = parse_tim(tim_path)
    M = design_matrix(par, tim)

    OBLIQUITY = np.deg2rad(23.439281)
    if "ELONG" in par.values or "LAMBDA" in par.values:
        lon = par.get("ELONG", par.get("LAMBDA"))
        lat = par.get("ELAT", par.get("BETA", 0.0))
        x = np.array([np.cos(lat) * np.cos(lon),
                      np.cos(lat) * np.sin(lon),
                      np.sin(lat)])
        ce, se = np.cos(OBLIQUITY), np.sin(OBLIQUITY)
        pos = np.array([x[0], ce * x[1] - se * x[2], se * x[1] + ce * x[2]])
    elif "RAJ" in par.values or "DECJ" in par.values:
        lon, lat = par.get("RAJ", 0.0), par.get("DECJ", 0.0)
        pos = np.array([np.cos(lat) * np.cos(lon),
                        np.cos(lat) * np.sin(lon),
                        np.sin(lat)])
    else:
        pos = np.zeros(3)   # unknown; the ORFs refuse zero-norm positions

    residuals = np.zeros_like(tim.mjds)
    if inject is not None:
        from .fourier import fourier_basis
        from .simulate import inject_residuals

        kw = dict(inject)
        nmodes = kw.pop("nmodes", 30)
        Tspan = kw.pop("Tspan", float(np.ptp(tim.mjds) * DAY))
        if Tspan <= 0:
            raise ValueError(
                f"{par.name}: cannot inject a red-noise realization with "
                f"Tspan={Tspan} (need >=2 distinct TOA epochs)")
        F, f = fourier_basis(tim.mjds, nmodes, Tspan)
        residuals, _ = inject_residuals(
            par.name, F, f, Tspan, tim.errs, M, **kw)

    return Pulsar(
        name=par.name,
        toas=tim.mjds * DAY,
        toaerrs=tim.errs,
        residuals=residuals,
        freqs=tim.freqs,
        backend_flags=_backend_labels(tim),
        Mmat=M,
        fitpars=list(par.fitted),
        flags={"pta": tim.flags[0].get("pta", "") if tim.flags else ""},
        pos=pos,
    )


def load_directory(dirpath, inject: dict | None = None, names=None) -> list:
    """Load every ``<name>.par``/``<name>.tim`` pair under ``dirpath``
    (sorted by file name; ``names`` keeps those stems only)."""
    dirpath = Path(dirpath)
    psrs = []
    for parf in sorted(dirpath.glob("*.par")):
        timf = parf.with_suffix(".tim")
        if not timf.exists():
            continue
        if names is not None and parf.stem not in names:
            continue
        psrs.append(load_pulsar(parf, timf, inject=inject))
    return psrs


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
