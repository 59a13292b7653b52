"""BayesEphem: the solar-system-ephemeris error model as a marginalized
basis.

The port's copy of ``pulsar_timing_gibbsspec_tpu/models/ephem.py``
(numpy only): ``model_general(bayesephem=True, be_type=...)`` adds, per
pulsar, 11 basis columns, the Roemer-delay partials of a frame drift
rate about the ecliptic pole, four outer-planet mass corrections and six
first-order Jupiter orbital-element patterns, derived from circular,
coplanar J2000 mean orbits.  The 11 amplitudes are marginalized as
basis coefficients with unit prior variance.

Every column is stored *sigma-scaled*: the delay partial times its
prior standard deviation (IAU mass uncertainties; the frame drift's
uniform prior moment-matched to a Gaussian; ~100 ns per orbital-element
pattern).  The marginal covariance ``sum_k sigma_k^2 t_k t_k^T`` is the
same as with raw partials and prior variances ``sigma_k^2``, but the
b-draw's Jacobi-preconditioned system stays well conditioned: raw
partials span ~22 decades between column norms and prior precisions.
The arithmetic is the reference's, operation for operation, so the
columns are bitwise the JAX package's.
"""

from __future__ import annotations

import numpy as np

AU_SEC = 499.00478384  # 1 AU light-travel time [s]
DAY = 86400.0
YEAR = 365.25 * DAY
MJD_J2000 = 51544.5
OBLIQUITY = np.deg2rad(23.439291111)

#: circular-orbit J2000 mean elements: semi-major axis [AU], sidereal
#: period [days], mean longitude at J2000 [deg]
PLANETS = {
    "jupiter": (5.20288700, 4332.589, 34.39644),
    "saturn": (9.53667594, 10759.22, 49.95424),
    "uranus": (19.18916464, 30685.4, 313.23810),
    "neptune": (30.06992276, 60189.0, -55.12003),
}
EARTH = (1.00000261, 365.256, 100.46457)

#: IAU mass-parameter uncertainties [solar masses]
MASS_SIGMA = {
    "jupiter": 1.54976690e-11,
    "saturn": 8.17306184e-12,
    "uranus": 5.71923361e-11,
    "neptune": 7.96103855e-11,
}

#: frame-drift prior half-width [rad/yr], moment-matched to a Gaussian
#: of variance w^2/3
FRAME_DRIFT_HALFWIDTH = 1e-9

#: 1-sigma induced Roemer delay per Jupiter orbital-element pattern [s]
ORB_ELEMENT_DELAY_SIGMA = 1e-7

BE_TYPES = ("orbel", "orbel-v2", "setIII", "setIII_1980")
#: columns of the basis
NCOLS = 11


def _ecl_to_eq(v):
    """Rotate ecliptic-frame vectors (..., 3) to the equatorial frame."""
    ce, se = np.cos(OBLIQUITY), np.sin(OBLIQUITY)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return np.stack([x, ce * y - se * z, se * y + ce * z], axis=-1)


def _orbit(toas_sec, elements):
    """Circular-orbit position [AU, equatorial] and mean longitude."""
    a, period_d, L0_deg = elements
    t_days = toas_sec / DAY - MJD_J2000
    L = np.deg2rad(L0_deg) + 2.0 * np.pi * t_days / period_d
    r_ecl = np.stack([a * np.cos(L), a * np.sin(L), np.zeros_like(L)],
                     axis=-1)
    return _ecl_to_eq(r_ecl), L


def bayesephem_basis(toas_sec, pos, be_type="setIII_1980"):
    """The (ntoa, 11) sigma-scaled basis of one pulsar at TOAs [s] and
    unit sky position ``pos``.  Raises ``ValueError`` for an unknown
    ``be_type`` or a position that is not a usable unit vector."""
    if be_type not in BE_TYPES:
        raise ValueError(f"be_type={be_type!r}; known: {BE_TYPES}")
    if not np.isfinite(pos).all() or np.linalg.norm(pos) < 0.5:
        raise ValueError(
            "bayesephem requires a usable pulsar sky position (par file "
            "lacked ELONG/ELAT and RAJ/DECJ)")
    n = np.asarray(pos, dtype=np.float64)
    t_yr = (toas_sec / DAY - MJD_J2000) * DAY / YEAR
    cols = []

    # frame drift at rate w [rad/yr]: Earth position error w t (z x r_E)
    r_earth, _ = _orbit(toas_sec, EARTH)
    z_ecl = _ecl_to_eq(np.array([0.0, 0.0, 1.0]))
    zxr = np.cross(np.broadcast_to(z_ecl, r_earth.shape), r_earth)
    frame_sigma = FRAME_DRIFT_HALFWIDTH / np.sqrt(3.0)
    cols.append(-(zxr @ n) * t_yr * AU_SEC * frame_sigma)

    # outer-planet mass errors: dm shifts the SSB by dm r_p
    for planet in ("jupiter", "saturn", "uranus", "neptune"):
        r_p, _ = _orbit(toas_sec, PLANETS[planet])
        cols.append((r_p @ n) * AU_SEC * MASS_SIGMA[planet])

    # Jupiter's orbital elements: first-order Keplerian patterns
    a_J, period_d, _ = PLANETS["jupiter"]
    r_J, L = _orbit(toas_sec, PLANETS["jupiter"])
    rhat = r_J / a_J
    that = _ecl_to_eq(np.stack([-np.sin(L), np.cos(L), np.zeros_like(L)],
                               axis=-1))
    zhat = np.broadcast_to(_ecl_to_eq(np.array([0.0, 0.0, 1.0])), r_J.shape)
    nt = 2.0 * np.pi * (toas_sec / DAY - MJD_J2000) / period_d
    nt = nt - nt.mean()
    patterns = [
        rhat,                                  # da: radial offset
        that,                                  # dM0/domega: along-track
        that * nt[:, None],                    # da: secular drift
        zhat * np.sin(L)[:, None],             # di
        zhat * np.cos(L)[:, None],             # dOmega
        (-rhat * np.cos(L)[:, None]
         + 2.0 * that * np.sin(L)[:, None]),   # de doublet
    ]
    for pat in patterns:
        cols.append((pat @ n) * ORB_ELEMENT_DELAY_SIGMA)
    return np.column_stack(cols)
