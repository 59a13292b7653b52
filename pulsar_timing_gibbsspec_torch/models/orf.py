"""Overlap reduction functions: the inter-pulsar correlation of a common
process.

The port's copy of ``pulsar_timing_gibbsspec_tpu/models/orf.py`` (numpy
only) for the fixed ORFs the correlated-ORF sampler takes: ``crn``,
``hd`` (Hellings-Downs), ``dipole``, ``monopole``, ``gw_monopole``,
``gw_dipole``, ``st`` (scalar transverse) and ``freq_hd`` (CRN below
frequency bin ``orf_ifreq``, Hellings-Downs from it upward).  Only the
positive-definite ones can serve as a Gibbs prior (hd, freq_hd, st,
gw_monopole, gw_dipole): :func:`orf_ginv_stack` refuses the others.

The ORFs with sampled correlation weights, ``bin_orf`` (one weight per
angular-separation bin of :data:`BIN_ORF_EDGES`) and ``legendre_orf``
(Legendre coefficients up to ``leg_lmax``), have ``G(theta) = I +
sum_j theta_j B_j`` with the basis of :func:`orf_param_basis`; they have
no fixed matrix, so :func:`orf_matrix` raises ``NotImplementedError``
for them.
"""

from __future__ import annotations

import numpy as np

#: ORFs whose shape is sampled: they have no fixed matrix
PARAMETERIZED_ORFS = ("param_hd", "param_multiple", "bin_orf", "legendre_orf",
                      "zero_diag_bin_orf", "zero_diag_legendre_orf")
#: angular-separation bin edges [deg] of ``bin_orf`` (7 bins)
BIN_ORF_EDGES = (0.0, 30.0, 50.0, 80.0, 100.0, 120.0, 150.0, 180.0)


def _same(pos_a, pos_b):
    return pos_a is pos_b or np.allclose(pos_a, pos_b)


def crn(pos_a, pos_b):
    """Common-spectrum uncorrelated process: identity correlation."""
    return 1.0 if _same(pos_a, pos_b) else 0.0


def hd(pos_a, pos_b):
    """Hellings-Downs quadrupolar correlation."""
    if _same(pos_a, pos_b):
        return 1.0
    x = (1.0 - np.dot(pos_a, pos_b)) / 2.0
    x = np.clip(x, 1e-15, None)
    return 1.5 * x * np.log(x) - 0.25 * x + 0.5


def dipole(pos_a, pos_b):
    if _same(pos_a, pos_b):
        return 1.0
    return float(np.dot(pos_a, pos_b))


def monopole(pos_a, pos_b):
    return 1.0


def gw_monopole(pos_a, pos_b):
    """Breathing-mode (monopolar GW) correlation: 1/2 off-diagonal."""
    return 1.0 if _same(pos_a, pos_b) else 0.5


def gw_dipole(pos_a, pos_b):
    """Dipolar-GW correlation: cos(zeta)/2 off-diagonal."""
    if _same(pos_a, pos_b):
        return 1.0
    return 0.5 * float(np.dot(pos_a, pos_b))


def st(pos_a, pos_b):
    """Scalar-transverse correlation: (3 + cos zeta)/8 off-diagonal, unit
    diagonal."""
    if _same(pos_a, pos_b):
        return 1.0
    return (3.0 + float(np.dot(pos_a, pos_b))) / 8.0


ORFS = {"crn": crn, "hd": hd, "dipole": dipole, "monopole": monopole,
        "gw_monopole": gw_monopole, "gw_dipole": gw_dipole, "st": st}


def orf_matrix(name: str, positions) -> np.ndarray:
    """(P, P) correlation matrix over pulsars for the named ORF;
    ``zero_diag_<orf>`` zeroes the diagonal (not positive definite)."""
    zero_diag = False
    if name.startswith("zero_diag_"):
        zero_diag = True
        name = name[len("zero_diag_"):]
    if name in PARAMETERIZED_ORFS:
        raise NotImplementedError(
            f"orf='{name}' has sampled shape parameters; sampling "
            "parameterized ORFs is not implemented")
    fn = ORFS[name]
    P = len(positions)
    for ii, p in enumerate(positions):
        if not np.isfinite(p).all() or np.linalg.norm(p) < 0.5:
            raise ValueError(
                f"pulsar {ii} has no usable sky position (par file lacked "
                f"ELONG/ELAT and RAJ/DECJ); cannot evaluate a correlated ORF")
    G = np.eye(P)
    for a in range(P):
        for b in range(a + 1, P):
            G[a, b] = G[b, a] = fn(positions[a], positions[b])
    if zero_diag:
        G = G - np.eye(P)
    return G


def orf_matrix_per_freq(name: str, positions, K: int,
                        orf_ifreq: int = 0) -> np.ndarray:
    """(K, P, P) per-frequency ORF stack: ``freq_hd`` is CRN below bin
    ``orf_ifreq`` and Hellings-Downs from it upward; any other fixed ORF
    gives a constant stack."""
    if name == "freq_hd":
        low = orf_matrix("crn", positions)
        high = orf_matrix("hd", positions)
        return np.stack([high if k >= orf_ifreq else low for k in range(K)])
    G = orf_matrix(name, positions)
    return np.broadcast_to(G, (K,) + G.shape).copy()


def orf_param_basis(name: str, positions, leg_lmax: int = 5):
    """``(B, labels)``: the (J, P, P) basis of a sampled-weight ORF,
    ``G(theta) = I + sum_j theta_j B_j``, zero on the diagonal (the
    process variance is rho_k's).  ``bin_orf``: ``B_j`` is 1 on the
    pairs whose separation lies in bin ``j`` of :data:`BIN_ORF_EDGES`
    (the first bin closed at 0); ``legendre_orf``: ``B_l = P_l(cos
    zeta)`` off the diagonal, ``l = 0..leg_lmax``.  A ``zero_diag_``
    variant has its full counterpart's basis."""
    if name.startswith("zero_diag_"):
        name = name[len("zero_diag_"):]
    P = len(positions)
    cosz = np.eye(P)
    for a in range(P):
        for b in range(a + 1, P):
            cosz[a, b] = cosz[b, a] = float(
                np.clip(np.dot(positions[a], positions[b]), -1.0, 1.0))
    off = 1.0 - np.eye(P)
    if name == "bin_orf":
        zeta = np.degrees(np.arccos(np.clip(cosz, -1.0, 1.0)))
        Bs, labels = [], []
        for j in range(len(BIN_ORF_EDGES) - 1):
            lo, hi = BIN_ORF_EDGES[j], BIN_ORF_EDGES[j + 1]
            mask = ((zeta > lo) if j else (zeta >= lo)) & (zeta <= hi)
            Bs.append(mask.astype(float) * off)
            labels.append(f"bin_{j}")
        return np.stack(Bs), labels
    if name == "legendre_orf":
        from scipy.special import eval_legendre

        Bs = [eval_legendre(l, cosz) * off for l in range(leg_lmax + 1)]
        return np.stack(Bs), [f"leg_{l}" for l in range(leg_lmax + 1)]
    raise NotImplementedError(f"parameterized orf '{name}'")


def orf_ginv_stack(name: str, positions, K: int,
                   orf_ifreq: int = 0) -> np.ndarray:
    """(K, P, P) inverse ORF stack of the correlated-ORF sampler, after
    checking that every matrix is positive definite."""
    Gk = orf_matrix_per_freq(name, positions, K, orf_ifreq=orf_ifreq)
    wmin = float(np.linalg.eigvalsh(Gk).min())
    if wmin <= 1e-10:
        reason = (
            "zero-diag/cross-correlation-only ORFs are detection-statistic "
            "constructions" if name.startswith("zero_diag_") else
            "this correlation matrix is rank-deficient (monopole is rank 1, "
            "dipole rank <= 3: the common process collapses onto a "
            "lower-dimensional subspace), so the coefficient prior is "
            "degenerate")
        raise NotImplementedError(
            f"orf='{name}' cannot serve as a Gibbs sampling prior: {reason} "
            f"(min eigenvalue {wmin:.2e}).  The reference cannot sample any "
            "correlated ORF either; positive-definite choices here: hd, "
            "freq_hd, st, gw_monopole, gw_dipole")
    return np.linalg.inv(Gk)
