"""Host helpers of the float64 NumPy oracle (``backend="numpy"``).

The port's copy of the NumPy part of ``pulsar_timing_gibbsspec_tpu/
sampler/blocks.py``: prior bounds of the free spectra, the generator's
state for ``adapt.npz``, the rho and t-process alpha grids with their
log-densities and the Gumbel-max draw, the reference's single-site
proposal, the kernel-ECORR Woodbury pieces and the red block's
differential-evolution history.  The oracle's parameter index groups
are :class:`.compiled.BlockIndex` and its sampling-flag check is
:func:`.blocks.validate_sampling_flags`, both shared with the device
path.  Everything here is NumPy in float64 on the host.

The Woodbury pieces take each epoch's log10_ecorr as an index into the
host model's ``xe = [x, 0, constants]`` (:meth:`.host_model.HostPTA.
map_params`) where the JAX functions take a parameter name or a
constant; the arithmetic is the same.
"""

from __future__ import annotations

import numpy as np

from ..config import settings


def rho_bounds(pta, frag: str = "gw") -> tuple:
    """(rho_min, rho_max) variance bounds: ``10^(2 * log10_rho prior
    bounds)`` of the first free-spectrum parameter whose name contains
    ``frag``; ``ValueError`` without one."""
    for p in pta.params:
        if "rho" in p.name and frag in p.name:
            return 10.0 ** (2.0 * p.a), 10.0 ** (2.0 * p.b)
    raise ValueError(f"no free-spectrum parameter matching '{frag}'")


_U64 = (1 << 64) - 1


def rng_state_pack(rng: np.random.Generator) -> np.ndarray:
    """A PCG64 generator's state as six uint64s (the 128-bit state and
    increment in halves, the cached uint32) for ``adapt.npz``."""
    st = rng.bit_generator.state
    s, inc = st["state"]["state"], st["state"]["inc"]
    return np.array([s & _U64, s >> 64, inc & _U64, inc >> 64,
                     int(st["has_uint32"]), st["uinteger"]], dtype=np.uint64)


def rng_state_unpack(rng: np.random.Generator, packed: np.ndarray):
    """Restore :func:`rng_state_pack`'s state into ``rng``."""
    st = rng.bit_generator.state
    p = [int(v) for v in packed]
    st["state"]["state"] = p[0] | (p[1] << 64)
    st["state"]["inc"] = p[2] | (p[3] << 64)
    st["has_uint32"] = p[4]
    st["uinteger"] = p[5]
    rng.bit_generator.state = st


def rho_grid(lo, hi, npts=None):
    """Log-uniform variance grid of the numerical rho conditionals
    (``settings.rho_grid_size`` points)."""
    return 10.0 ** np.linspace(np.log10(lo), np.log10(hi),
                               npts or settings.rho_grid_size)


def rho_log_pdf_grid(tau, other, grid):
    """Log conditional density of one pulsar's free-spectrum term on the
    rho grid: ``r - e^r`` with ``r = log tau - log(other + rho)``; ``tau
    = 0`` gives ``-inf`` without a warning."""
    with np.errstate(divide="ignore"):
        logratio = (np.log(tau)[:, None]
                    - np.logaddexp(np.log(other)[:, None],
                                   np.log(grid)[None, :]))
    return logratio - np.exp(logratio)


def tprocess_alpha_log_pdf_grid(tau, plaw, other, grid):
    """Log point mass of the t-process scale factors on a log-spaced
    alpha grid: the InvGamma(1, 1) prior times the two-coefficient
    Gaussian likelihood of variance ``other + alpha * plaw``, with the
    grid's Jacobian."""
    var = other[:, None] + plaw[:, None] * grid[None, :]
    return (-np.log(grid)[None, :] - 1.0 / grid[None, :]
            - np.log(var) - tau[:, None] / var)


def gumbel_grid_draw(rng, logpdf, grid):
    """One grid point per row by the Gumbel-max trick (the inverse CDF of
    the discrete density)."""
    gum = rng.gumbel(size=logpdf.shape)
    return grid[np.argmax(logpdf + gum, axis=-1)]


def align_phi(raw, k):
    """Truncate or floor-pad (1e-30) a per-frequency phi to ``k``
    entries."""
    out = np.full(k, 1e-30)
    n = min(k, len(raw))
    out[:n] = raw[:n]
    return out


def proposal_step(rng, x, idx, sigma):
    """The reference's single-site scale-mixture proposal: one coordinate
    of ``idx`` jumps by ``N(0, 1) * sigma * scale``, scale from {0.1,
    0.5, 1, 3, 10} with probabilities {.1, .15, .5, .15, .1}."""
    q = x.copy()
    scale = rng.choice([0.1, 0.5, 1.0, 3.0, 10.0],
                       p=[0.1, 0.15, 0.5, 0.15, 0.1])
    par = rng.choice(idx)
    q[par] += rng.standard_normal() * sigma * scale
    return q


def ke_woodbury(xe, Nvec, eid, E, par_ix):
    """Per-epoch Woodbury pieces of a kernel-ECORR block ``N = D + U c
    U^T`` (disjoint epoch indicators U): ``c_e = 10^(2 log10_ecorr_e)``
    (``xe[par_ix]``), ``s_e = sum_(i in e) 1 / D_i``, ``w_e = c_e / (1 +
    c_e s_e)``; ``eid`` maps TOAs to epochs, ``E`` the one outside
    them."""
    c = 10.0 ** (2.0 * xe[par_ix])
    s = np.bincount(eid, weights=1.0 / Nvec, minlength=E + 1)[:E]
    return c, s, c / (1.0 + c * s)


def ke_corr(xe, Nvec, r, eid, E, par_ix):
    """Woodbury correction to the diagonal Gaussian log-density of ``r``:
    ``-0.5 [sum log1p(c s) - sum w z^2]`` with ``z_e = sum r / D``."""
    c, s, w = ke_woodbury(xe, Nvec, eid, E, par_ix)
    z = np.bincount(eid, weights=r / Nvec, minlength=E + 1)[:E]
    return -0.5 * (np.sum(np.log1p(c * s)) - np.sum(w * z * z))


def ke_tnt_corr(T, y, Nvec, w, eid, E):
    """Woodbury correction to the augmented Gram ``[T|y]^T N^-1 [T|y]``:
    ``V^T diag(w) V`` with ``V_e = sum_(i in e) [T|y]_i / D_i``; the
    last row and column carry the ``d = T^T N^-1 y`` correction."""
    A = np.column_stack([T, y]) / Nvec[:, None]
    V = np.zeros((E + 1, A.shape[1]))
    np.add.at(V, eid, A)
    V = V[:E]
    return (V * w[:, None]).T @ V


def de_step(rng, x, idx, hist):
    """Differential-evolution proposal from a past-sample history: ``q =
    x + gamma (h_a - h_b)`` over two distinct rows, ``gamma = 2.38 /
    sqrt(2 d)`` and 1 on 10% of jumps."""
    H = len(hist)
    a = rng.integers(H)
    b = (a + 1 + rng.integers(H - 1)) % H
    gamma = 1.0 if rng.uniform() < 0.1 else 2.38 / np.sqrt(2.0 * len(idx))
    q = x.copy()
    q[idx] += gamma * (np.asarray(hist[a]) - np.asarray(hist[b]))
    return q


def de_hist_push(hist, pend, count, row, period=128):
    """Frozen-window DE history: new states roll into ``pend`` while
    :func:`de_step` reads the frozen ``hist``, which refreshes from
    ``pend`` every ``period`` pushes.  Returns ``(hist, pend, count)``."""
    pend = np.roll(pend, -1, axis=0)
    pend[-1] = row
    count = int(count) + 1
    if count % period == 0:
        hist = pend.copy()
    return hist, pend, count


def seed_red_hist(rec, hist_len=64):
    """Thin a post-burn adaptation record (steps, d) to a (hist_len, d)
    DE history seed."""
    rec = np.asarray(rec, dtype=np.float64)
    take = np.linspace(0, len(rec) - 1, hist_len).astype(int)
    return rec[take]
