"""Linear timing-model design matrix.

A copy of ``pulsar_timing_gibbsspec_tpu/data/design.py``.  Only the
column space of the timing design matrix matters to the sampler (its
columns are marginalized with an effectively infinite prior variance),
so the matrix is built from the par file's fitted parameters with the
leading-order timing partials:

- phase offset, spin frequency and derivatives  -> ``1, t, t^2 (, t^3)``
- sky position                                  -> annual sin/cos
- proper motion                                 -> ``t *`` annual sin/cos
- parallax                                      -> semi-annual sin/cos
- DM and derivatives                            -> ``1/nu^2 (, t/nu^2)``
- DMX windows (DMX_/DMXR1_/DMXR2_)              -> windowed ``1/nu^2``
- FD profile-evolution terms                    -> ``log(nu/1 GHz)^k``
- JUMP system offsets (flag/MJD form)           -> indicator columns
- Keplerian binary parameters                   -> orbital-phase harmonics
  (2 harmonics; +2 more when Shapiro-sensitive params M2/SINI/KIN are
  fitted, since the Shapiro delay is sharply peaked at conjunction)

Columns numerically inside the span of earlier ones are dropped
(:func:`_degenerate_keep`).
"""

from __future__ import annotations

import re

import numpy as np

from .partim import ParFile, TimFile

DAY = 86400.0
YEAR = 365.25 * DAY

_FD_RE = re.compile(r"^FD(\d+)$")


def design_matrix(par: ParFile, tim: TimFile, return_labels: bool = False):
    """Build the (n_toa, n_col) timing design matrix for the fitted params.

    With ``return_labels=True`` also returns one name per surviving
    column (the enterprise ``fitpars``-style surface: real DMX_/FD/JUMP
    tags where the par file carries them, generic partial names
    elsewhere)."""
    t = (tim.mjds - tim.mjds.mean()) * DAY            # seconds, centered
    tyr = 2.0 * np.pi * t / YEAR                      # annual phase
    cols = [np.ones_like(t)]                          # overall phase offset
    labels = ["Offset"]

    fitted = set(par.fitted)

    # spin frequency and derivatives
    if "F0" in fitted:
        cols.append(t)
        labels.append("F0")
    if "F1" in fitted:
        cols.append(t**2)
        labels.append("F1")
    if "F2" in fitted:
        cols.append(t**3)
        labels.append("F2")

    # astrometry: position -> annual; proper motion -> t * annual;
    # parallax -> semi-annual
    if fitted & {"RAJ", "DECJ", "ELONG", "ELAT", "LAMBDA", "BETA"}:
        cols += [np.sin(tyr), np.cos(tyr)]
        labels += ["POS_SIN", "POS_COS"]
    if fitted & {"PMRA", "PMDEC", "PMELONG", "PMELAT", "PMLAMBDA", "PMBETA"}:
        cols += [t * np.sin(tyr), t * np.cos(tyr)]
        labels += ["PM_SIN", "PM_COS"]
    if "PX" in fitted:
        cols += [np.sin(2 * tyr), np.cos(2 * tyr)]
        labels += ["PX_SIN", "PX_COS"]

    # dispersion measure
    nu2 = (tim.freqs / 1400.0) ** 2
    nu2 = np.where(nu2 > 0, nu2, 1.0)
    if "DM" in fitted and np.ptp(tim.freqs) > 0:
        cols.append(1.0 / nu2)
        labels.append("DM")
    if "DM1" in fitted and np.ptp(tim.freqs) > 0:
        cols.append(t / nu2)
        labels.append("DM1")

    # DMX: piecewise-constant dispersion windows, the NANOGrav convention
    # (fitted DMX_#### with DMXR1_/DMXR2_ window bounds), the column
    # structure tempo2 gives an enterprise pulsar
    if np.ptp(tim.freqs) > 0:
        for key in sorted(fitted):
            if not key.startswith("DMX_"):
                continue
            tag = key[len("DMX_"):]
            r1 = par.get(f"DMXR1_{tag}")
            r2 = par.get(f"DMXR2_{tag}")
            if r1 is None or r2 is None:
                continue          # no window bounds -> no lever arm
            win = (tim.mjds >= r1) & (tim.mjds <= r2)
            if win.any():
                cols.append(win / nu2)
                labels.append(key)

    # FD: frequency-dependent profile-evolution delay,
    # FDk -> log(nu / 1 GHz)^k (tempo2 definition)
    lognu = np.log(np.where(tim.freqs > 0, tim.freqs, 1000.0) / 1000.0)
    for key in sorted(fitted):
        m = _FD_RE.match(key)
        if m and np.ptp(tim.freqs) > 0:
            cols.append(lognu ** int(m.group(1)))
            labels.append(key)

    # JUMP: fitted inter-system offsets.  Flag form selects TOAs by a tim
    # flag value; MJD form by an epoch window.  Only entries carrying the
    # tempo2 fit flag "1" become columns (unfitted jumps are fixed
    # delays, not free parameters).  The fit flag is POSITIONAL — the
    # field after the offset value — because tempo2 writes a trailing
    # uncertainty ("JUMP -fe Rcvr_800 -8.8e-06 1 1.2e-07") that a
    # last-token test would misread.
    # Labels count FITTED jumps (tempo2's JUMP_1..JUMP_n are per fitted
    # parameter), not raw par-file lines — skipped unfitted entries must
    # not leave holes in the numbering.
    n_jump = 0
    for toks in par.jumps:
        if toks and toks[0].upper() == "MJD" and len(toks) >= 5:
            if toks[4] != "1":
                continue
            t1, t2 = float(toks[1]), float(toks[2])
            sel = (tim.mjds >= t1) & (tim.mjds <= t2)
        elif toks and toks[0].startswith("-") and len(toks) >= 4:
            if toks[3] != "1":
                continue
            flag, val = toks[0][1:], toks[1]
            sel = np.array([fl.get(flag) == val for fl in tim.flags])
        else:
            continue
        if sel.any() and not sel.all():
            n_jump += 1
            cols.append(sel.astype(float))
            labels.append(f"JUMP{n_jump}")

    # binary: harmonics of the orbital phase
    kepler = {"PB", "T0", "TASC", "A1", "OM", "ECC", "EPS1", "EPS2",
              "PBDOT", "XDOT", "OMDOT", "M2", "SINI", "KIN", "KOM", "GAMMA"}
    fitted_binary = fitted & kepler
    pb = par.get("PB")
    if fitted_binary and pb:
        t0 = par.get("T0", par.get("TASC", tim.mjds.mean()))
        phase = 2.0 * np.pi * ((tim.mjds - t0) / pb)
        n_harm = 2
        if fitted_binary & {"M2", "SINI", "KIN"}:
            n_harm = 4
        for k in range(1, n_harm + 1):
            cols += [np.sin(k * phase), np.cos(k * phase)]
            labels += [f"ORB_S{k}", f"ORB_C{k}"]

    M = np.column_stack(cols)
    keep = _degenerate_keep(M)
    if return_labels:
        return M[:, keep], [labels[j] for j in keep]
    return M[:, keep]


def _degenerate_keep(M: np.ndarray, rtol: float = 1e-10) -> list:
    """Indices of columns NOT numerically inside the span of earlier ones.

    The rank test runs on unit-normalized columns; raw timing partials span
    ~18 orders of magnitude (t^2 in s^2 vs the ones column) and would
    otherwise defeat a scale-blind singular-value threshold.
    """
    norms = np.linalg.norm(M, axis=0)
    Mn = M / np.where(norms > 0, norms, 1.0)
    keep = []
    for j in range(Mn.shape[1]):
        if norms[j] == 0:
            continue
        s = np.linalg.svd(Mn[:, keep + [j]], compute_uv=False)
        if s[-1] > rtol * s[0]:
            keep.append(j)
    return keep
