"""tempo2 ``.par`` / ``.tim`` text readers.

A copy of ``pulsar_timing_gibbsspec_tpu/data/partim.py``: a
dependency-free reader of tempo2 text formats (fit flags, D exponents,
sexagesimal and ecliptic coordinates, flag- and MJD-form JUMP lines;
``FORMAT 1`` tim files with ``INCLUDE`` and per-TOA ``-flag value``
pairs).  The sampler consumes residuals plus a linear design matrix
(:mod:`.design`), not a full timing solution.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

import numpy as np

#: par-file keys that are switches/strings, never fitted numeric parameters
_NON_NUMERIC_KEYS = {
    "PSRJ", "PSRB", "PSR", "BINARY", "EPHEM", "CLK", "UNITS", "TIMEEPH",
    "T2CMETHOD", "CORRECT_TROPOSPHERE", "PLANET_SHAPIRO", "DILATEFREQ",
    "INFO", "NITS", "NTOA", "TRES", "MODE", "EPHVER", "DCOVFILE", "TZRSITE",
}


@dataclasses.dataclass
class ParFile:
    """Parsed timing model: parameter values and which are fitted."""

    name: str
    values: dict          # key -> float value (numeric entries only)
    fitted: list          # keys flagged for fitting ("1" in the fit column)
    raw: dict             # key -> list of raw string fields
    #: JUMP lines, one token list each (tempo2 allows many JUMP entries;
    #: a dict keyed by "JUMP" would keep only the last) — flag form
    #: ``-flag value offset [fit]`` or MJD form ``MJD t1 t2 offset [fit]``
    jumps: list = dataclasses.field(default_factory=list)

    def __getitem__(self, key):
        return self.values[key]

    def get(self, key, default=None):
        return self.values.get(key, default)


def _to_float(tok: str):
    """Parse a tempo2 numeric token (allows D-exponent Fortran style)."""
    try:
        return float(tok.replace("D", "E").replace("d", "e"))
    except ValueError:
        return None


def parse_par(path) -> ParFile:
    """Read a tempo2 par file.

    Layout per line: ``KEY value [fitflag] [uncertainty]``.  The fit flag is
    the literal field ``1`` in the third column (tempo2 convention).  RAJ/DECJ
    sexagesimal values are converted to radians; ELONG/ELAT degrees to
    radians.
    """
    values, fitted, raw, jumps = {}, [], {}, []
    name = Path(path).stem
    for line in Path(path).read_text().splitlines():
        toks = line.split()
        if not toks or toks[0].startswith("#"):
            continue
        key = toks[0].upper()
        raw[key] = toks[1:]
        if key == "JUMP" and len(toks) > 1:
            # repeated lines, non-numeric second field — collected whole
            # for design_matrix (flag-selected / MJD-windowed offsets)
            jumps.append(toks[1:])
            continue
        if key in ("PSRJ", "PSRB", "PSR") and len(toks) > 1:
            name = toks[1]
            continue
        if key in _NON_NUMERIC_KEYS or len(toks) < 2:
            continue
        if key in ("RAJ", "DECJ"):
            val = _sexagesimal_to_rad(toks[1], hours=(key == "RAJ"))
        else:
            val = _to_float(toks[1])
        if val is None:
            continue
        if key in ("ELONG", "ELAT", "LAMBDA", "BETA"):
            values[key] = np.deg2rad(val)
        else:
            values[key] = val
        # fit flag: a bare "1" in column 3 (not an uncertainty like "1.5e-3")
        if len(toks) >= 3 and toks[2] == "1":
            fitted.append(key)
    return ParFile(name=name, values=values, fitted=fitted, raw=raw,
                   jumps=jumps)


def _sexagesimal_to_rad(tok: str, hours: bool) -> float:
    parts = tok.split(":")
    if len(parts) == 1:
        return float(tok)
    sign = -1.0 if parts[0].strip().startswith("-") else 1.0
    mags = [abs(float(p)) for p in parts] + [0.0, 0.0]
    deg = mags[0] + mags[1] / 60.0 + mags[2] / 3600.0
    if hours:
        deg *= 15.0
    return sign * np.deg2rad(deg)


@dataclasses.dataclass
class TimFile:
    """Parsed TOAs. MJDs kept at float128-free double precision; the sampler
    only ever uses TOA *differences* (span ~15 yr), where f64 is ~µs-exact."""

    mjds: np.ndarray       # (n,) TOA epochs [MJD, f64]
    errs: np.ndarray       # (n,) TOA uncertainties [seconds]
    freqs: np.ndarray      # (n,) observing frequencies [MHz]
    flags: list            # (n,) dict of -flag value pairs per TOA
    sites: list            # (n,) observatory codes


def parse_tim(path) -> TimFile:
    """Read a tempo2 ``FORMAT 1`` tim file.

    Line layout: ``name freq mjd err site [-flag value ...]`` with err in
    microseconds.  ``INCLUDE`` directives are followed; comment/command lines
    are skipped.
    """
    mjds, errs, freqs, flags, sites = [], [], [], [], []
    path = Path(path)
    for line in path.read_text().splitlines():
        s = line.strip()
        if s.upper().startswith("INCLUDE") and len(s.split()) > 1:
            sub = parse_tim(path.parent / s.split()[1])
            mjds += list(sub.mjds); errs += list(sub.errs)
            freqs += list(sub.freqs); flags += sub.flags; sites += sub.sites
            continue
        if not s or s.startswith(("#", "C ", "CODE", "FORMAT", "MODE", "EFAC", "EQUAD", "TIME", "JUMP", "SKIP", "NOSKIP")):
            continue
        toks = s.split()
        if len(toks) < 5:
            continue
        freq, mjd, err = _to_float(toks[1]), _to_float(toks[2]), _to_float(toks[3])
        if freq is None or mjd is None or err is None:
            continue
        fl = {}
        ii = 5
        while ii < len(toks):
            if toks[ii].startswith("-") and not _is_number(toks[ii]) and ii + 1 < len(toks):
                fl[toks[ii][1:]] = toks[ii + 1]
                ii += 2
            else:
                ii += 1
        mjds.append(mjd)
        errs.append(err * 1e-6)          # µs -> s
        freqs.append(freq)
        flags.append(fl)
        sites.append(toks[4])
    order = np.argsort(np.asarray(mjds, dtype=np.float64), kind="stable")
    return TimFile(
        mjds=np.asarray(mjds, dtype=np.float64)[order],
        errs=np.asarray(errs, dtype=np.float64)[order],
        freqs=np.asarray(freqs, dtype=np.float64)[order],
        flags=[flags[i] for i in order],
        sites=[sites[i] for i in order],
    )


_NUM_RE = re.compile(r"^-?(\d+\.?\d*|\.\d+)([eEdD][+-]?\d+)?$")


def _is_number(tok: str) -> bool:
    return bool(_NUM_RE.match(tok))
