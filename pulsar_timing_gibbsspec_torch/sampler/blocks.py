"""Gibbs blocks of the CRN free-spectrum sweep, batched over chains.

Port of the CRN pieces of ``pulsar_timing_gibbsspec_tpu/sampler/
jax_backend.py``: the segmented Grams and the b-draws (steady
Metropolised draw, refresh, exact draw), the white-noise block
(relative likelihood, adapted full-block MH, Laplace proposals), and the
hyper block (common-rho grid draw, per-pulsar red draw, rho <-> b scale
moves).  Every function takes the chains as leading dimensions of ``x``
(``(C, nx)``), ``b`` (``(C, P, Bmax)``) and ``u = T b`` (``(C, P,
Nmax)``); the kernels see ``C * P`` systems at once.

Each stochastic block is split: ``*_core`` takes its noise as tensors
(normals, log-uniforms, Gumbels, drawn as the JAX function draws them),
and the wrapper of the same name without the suffix draws that noise
from an explicit ``torch.Generator``.  The tests feed the JAX-drawn noise
to the cores.  Numerics constants are the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import settings
from ..ops import kernels
from ..ops.linalg import _batched_diag, mvn_conditional_draw

_SCALES = (0.1, 0.5, 1.0, 3.0, 10.0)
_SCALE_P = (0.1, 0.15, 0.5, 0.15, 0.1)
#: sweeps between Metropolised near-exact refreshes of the b-draw
EXACT_EVERY = 16
#: ridge on the float32-preconditioned proposal system
_PROP_RIDGE = 4e-6
#: step scale (natural log of the variance ratio) of the rho <-> b moves
RHO_SCALE_SIGMA = 0.65
_LN10 = math.log(10.0)


# ===========================================================================
# noise
# ===========================================================================

def _normal(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _uniform(gen, shape, dtype, device):
    u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return torch.clamp(u, min=torch.finfo(dtype).tiny)


def _gumbel(gen, shape, dtype, device):
    return -torch.log(-torch.log(_uniform(gen, shape, dtype, device)))


def _scale_choice(gen, shape, dtype, device):
    """Draws from ``_SCALES`` with probabilities ``_SCALE_P`` (inverse
    CDF of one uniform; no host tensor is copied to the device, which
    would serialize the host with the card)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=device)
    out = torch.full(shape, _SCALES[-1], dtype=dtype, device=device)
    for cut, val in zip(np.cumsum(_SCALE_P)[:-1][::-1], _SCALES[-2::-1]):
        out = torch.where(u < float(cut), val, out)
    return out


# ===========================================================================
# index helpers
# ===========================================================================

def _set_x(x, ix, vals):
    """``x.at[ix].set(vals, mode="drop")`` over the last axis: ``ix``
    (P, W) indexes x's last axis, pads point at ``nx`` and are dropped."""
    nx = x.shape[-1]
    lead = x.shape[:-1]
    flat = ix.reshape(-1).expand(lead + (ix.numel(),))
    ext = torch.cat([x, x.new_zeros(lead + (1,))], -1)
    ext = ext.scatter(-1, flat, vals.reshape(lead + (-1,)).to(x.dtype))
    return ext[..., :nx]


def _add_x(x, ix, vals):
    """``x.at[ix].add(vals, mode="drop")`` over the last axis."""
    nx = x.shape[-1]
    lead = x.shape[:-1]
    flat = ix.reshape(-1).expand(lead + (ix.numel(),))
    ext = torch.cat([x, x.new_zeros(lead + (1,))], -1)
    ext = ext.scatter_add(-1, flat,
                          vals.reshape(lead + (-1,)).to(x.dtype))
    return ext[..., :nx]


def _take_cols(b, ix):
    """``b[..., p, ix[p]]`` for a per-pulsar column index ``ix`` (P,)."""
    return torch.gather(b, -1, ix[:, None].expand(b.shape[:-1] + (1,)))[
        ..., 0]


# ===========================================================================
# Grams and b-draws
# ===========================================================================

def _gram_operands(cm, Nvec, seg_len):
    """``TNa = Ta / N`` (..., P, nseg, m, B1) and ``Ta = [T | y]``
    (P, nseg, m, B1), the TOA axis split into equal segments; pad TOA
    rows are zero and contribute nothing."""
    Ta = torch.cat([cm.T, cm.y[..., None]], dim=-1)
    TNa = Ta / Nvec.to(cm.dtype)[..., None]
    P, N, B1 = Ta.shape
    nseg = max(1, -(-N // seg_len))
    m = -(-N // nseg)
    if nseg * m != N:
        pad = nseg * m - N
        Ta = torch.nn.functional.pad(Ta, (0, 0, 0, pad))
        TNa = torch.nn.functional.pad(TNa, (0, 0, 0, pad))
    lead = TNa.shape[:-3]
    return (TNa.reshape(lead + (P, nseg, m, B1)),
            Ta.reshape(P, nseg, m, B1))


def _gram(cm, Nvec, seg_len, out_dtype, widen):
    TNa, Ta = _gram_operands(cm, Nvec, seg_len)
    lead = TNa.shape[:-3]
    G = kernels.gram_accumulate(TNa.reshape((-1,) + TNa.shape[-3:]), Ta,
                                out_dtype=out_dtype, widen=widen)
    G = G.reshape(lead + G.shape[-2:])
    return G[..., :cm.Bmax, :cm.Bmax], G[..., :cm.Bmax, cm.Bmax]


def tnt_d(cm, Nvec, seg_len=None):
    """``(T^T N^-1 T, T^T N^-1 y)`` with exact (float64) accumulation of
    the float32 operands, segments reduced in order."""
    return _gram(cm, Nvec, seg_len or settings.gram_seg_len_exact,
                 cm.cdtype, True)


def tnt_d_seg(cm, Nvec, seg_len=None):
    """Float32 segment products reduced in float64 (the refresh Gram)."""
    return _gram(cm, Nvec, seg_len or settings.gram_seg_len, cm.cdtype,
                 False)


def tnt_d_seg32(cm, Nvec, seg_len=None):
    """All-float32 segmented Gram (the steady proposal Gram)."""
    return _gram(cm, Nvec, seg_len or settings.gram_seg_len, cm.dtype,
                 False)


def tnt_d_x(cm, x, Nvec):
    """``(TNT, d)`` for the current state (diagonal N)."""
    return tnt_d(cm, Nvec)


def b_matvec(cm, b):
    """``u = T b`` in the storage dtype, (..., P, Nmax)."""
    return torch.matmul(cm.T, b.to(cm.dtype)[..., None])[..., 0]


def residual_sq(cm, b):
    """``(y - T b)^2`` in the storage dtype."""
    r = cm.y - b_matvec(cm, b)
    return r * r


def _logpi_b_per(cm, x, b, u):
    """Per-pulsar ``log pi(b | x)`` up to b-independent constants, from
    ``u = T b``: ``-0.5 u^2/N + (y/N) u - 0.5 b^2/phi``; float32
    elementwise, float64 sums."""
    N = cm.ndiag_fast(x)
    t1 = (-0.5 * u + cm.y) * (u / N) * cm.toa_mask
    phi32 = cm.phi(x, dtype=cm.dtype)
    bb = b.to(cm.dtype)
    t2 = -0.5 * bb * bb / phi32
    return (t1.to(cm.cdtype).sum(-1) + t2.to(cm.cdtype).sum(-1))


def _logpi_b_pair(cm, x, b_old, b_new, u_old, u_new):
    """Both sides of the b MH ratio in one pass; ``(lpi_old,
    lpi_new)``, each (..., P) in the compute dtype."""
    N = cm.ndiag_fast(x)
    uu = torch.stack([u_old, u_new])
    t1 = (-0.5 * uu + cm.y) * (uu / N) * cm.toa_mask
    phi32 = cm.phi(x, dtype=cm.dtype)
    bb = torch.stack([b_old, b_new]).to(cm.dtype)
    t2 = -0.5 * bb * bb / phi32
    lp = t1.to(cm.cdtype).sum(-1) + t2.to(cm.cdtype).sum(-1)
    return lp[0], lp[1]


def _factor_batch(Sig, d, z, **kw):
    """Run the factor chain over the flattened ``(..., P)`` batch."""
    lead = Sig.shape[:-2]
    B = Sig.shape[-1]
    outs = kernels.chol_solve_sample(
        Sig.reshape(-1, B, B), d.reshape(-1, B), z.reshape(-1, B), **kw)
    return tuple(o.reshape(lead + o.shape[1:]) for o in outs)


def _log_ratio(cm, x, b, u, L, mean, dj, bp, z, w_dtype):
    """Exact log Hastings ratio of proposal ``bp`` (drawn as ``mean +
    dj * Li^T z``) against the current ``b``, and ``up = T bp``."""
    up = b_matvec(cm, bp)
    lpi_old, lpi_new = _logpi_b_pair(cm, x, b, bp, u, up)
    v = (b.to(w_dtype) - mean) / dj
    w_old = torch.matmul(L.transpose(-1, -2), v[..., None])[..., 0]
    logq_old = -0.5 * (w_old * w_old).sum(-1).to(cm.cdtype)
    logq_new = -0.5 * (z * z).sum(-1).to(cm.cdtype)
    return (lpi_new - lpi_old) + (logq_old - logq_new), up


def _accept(b, u, bp, up, logr, ok, logu):
    acc = ok & (logr > logu)
    return (torch.where(acc[..., None], bp, b),
            torch.where(acc[..., None], up, u), acc)


def propose_b_mh(cm, x, b, u, z):
    """The steady proposal: the float32-factored conditional (segmented
    float32 Gram, fused factor chain with the ``_PROP_RIDGE`` guard) at
    float32 normals ``z`` (..., P, Bmax).  Returns ``(bp, up, logr, ok,
    L, dj)``: proposal, its ``T bp``, the exact log Hastings ratio, the
    finiteness mask, and the preconditioned factor and scaling that
    whiten the proposal (``L^T (v / dj)`` is in proposal-sd units)."""
    fdt = cm.dtype
    N = cm.ndiag_fast(x)
    TNT, d = tnt_d_seg32(cm, N)
    phi32 = cm.phi(x, dtype=fdt)
    eye = torch.eye(cm.Bmax, dtype=fdt, device=cm.device)
    Sig = TNT + (1.0 / phi32)[..., :, None] * eye
    L, Li, dj, mean, bp32 = _factor_batch(Sig, d, z, ridge=_PROP_RIDGE)
    bp = bp32.to(cm.cdtype)
    logr, up = _log_ratio(cm, x, b, u, L, mean, dj, bp, z, fdt)
    ok = torch.isfinite(bp32).all(-1) & torch.isfinite(logr)
    return bp, up, logr, ok, L, dj


def draw_b_mh_core(cm, x, b, u, z, logu):
    """Metropolised b-draw: the :func:`propose_b_mh` proposal accepted
    per pulsar with the exact Hastings ratio against ``logu`` (..., P)
    float64 log-uniforms.  Returns ``(b', u', accepted)``."""
    bp, up, logr, ok = propose_b_mh(cm, x, b, u, z)[:4]
    return _accept(b, u, bp, up, logr, ok, logu)


def draw_b_mh(cm, x, b, u, gen):
    """:func:`draw_b_mh_core` with its noise drawn from ``gen``."""
    z = _normal(gen, b.shape, cm.dtype, cm.device)
    logu = torch.log(_uniform(gen, b.shape[:-1], cm.cdtype, cm.device))
    return draw_b_mh_core(cm, x, b, u, z, logu)


def propose_b_refresh(cm, x, b, u, z):
    """The refresh proposal: the float32-segment/float64-reduce Gram
    factored by the two-float ``tf`` factor (ridge corrected) at float64
    normals ``z``.  Returns ``(bp, up, logr, ok, L, dj)`` as
    :func:`propose_b_mh` does."""
    N = cm.ndiag_fast(x)
    TNT, d = tnt_d_seg(cm, N)
    phi = cm.phi(x)
    Sig = TNT + _batched_diag(1.0 / phi)
    L, Li, dj, mean, bp = _factor_batch(Sig, d, z, ridge=_PROP_RIDGE,
                                        factor="tf")
    logr, up = _log_ratio(cm, x, b, u, L, mean, dj, bp, z, cm.cdtype)
    ok = torch.isfinite(bp).all(-1) & torch.isfinite(logr)
    return bp, up, logr, ok, L, dj


def draw_b_refresh_core(cm, x, b, u, z, logu):
    """Near-exact Metropolised refresh: the :func:`propose_b_refresh`
    proposal accepted with the exact Hastings ratio.  Returns ``(b',
    u', accepted)``."""
    bp, up, logr, ok = propose_b_refresh(cm, x, b, u, z)[:4]
    return _accept(b, u, bp, up, logr, ok, logu)


def draw_b_refresh(cm, x, b, u, gen):
    """:func:`draw_b_refresh_core` with its noise drawn from ``gen``."""
    z = _normal(gen, b.shape, cm.cdtype, cm.device)
    logu = torch.log(_uniform(gen, b.shape[:-1], cm.cdtype, cm.device))
    return draw_b_refresh_core(cm, x, b, u, z, logu)


def draw_b_fn_core(cm, x, z, b=None):
    """Exact b | everything for the CRN model: float64-accumulated Gram,
    float64 blocked factor, ``mean + Sigma^-1/2 z`` with ``z`` (..., P,
    Bmax) float64 normals.

    A pulsar whose draw is not finite keeps its current ``b`` (zeros
    when none is given): the float32-rounded Gram loses positive
    definiteness at some warmup states (one backend's efac far below 1).
    That is the JAX package's guard on its joint draw ("skip the whole
    update rather than poison the chain", ``jax_backend.py:1099``); its
    CRN draw has none, and a NaN ``b`` there is never replaced: every
    later Metropolised draw rejects against it."""
    if cm.orf_name != "crn":
        raise NotImplementedError("correlated ORFs are not in the port yet")
    N = cm.ndiag_fast(x)
    TNT, d = tnt_d_x(cm, x, N)
    phi = cm.phi(x)
    bn, _ = mvn_conditional_draw(TNT, 1.0 / phi, d, z)
    if b is None:
        b = torch.zeros_like(bn)
    return torch.where(torch.isfinite(bn).all(-1, keepdim=True), bn, b)


def draw_b_fn(cm, x, gen, b=None):
    """:func:`draw_b_fn_core` with its noise drawn from ``gen``."""
    z = _normal(gen, x.shape[:-1] + (cm.P, cm.Bmax), cm.cdtype, cm.device)
    return draw_b_fn_core(cm, x, z, b)


# ===========================================================================
# white-noise block
# ===========================================================================

def lnlike_white_per(cm, x, r2):
    """Per-pulsar white-noise log-likelihood given b, (..., P), in the
    sigma^2-scaled form ``N = sigma^2 M`` (every intermediate of value,
    gradient and Hessian O(1)-O(1e4))."""
    cdt = cm.cdtype
    xev = cm.xe(x)
    efac = xev[..., cm.efac_ix]
    equad = xev[..., cm.equad_ix]
    gequad = xev[..., cm.gequad_ix]
    s2 = cm.sigma2.to(cdt)
    ln_s2 = torch.log(s2)
    ln10_2 = 2.0 * _LN10
    M = (efac * efac + torch.exp(ln10_2 * equad - ln_s2)
         + torch.exp(ln10_2 * gequad - ln_s2))
    w = r2.to(cdt) / s2
    return -0.5 * (cm.toa_mask * (ln_s2 + torch.log(M) + w / M)).sum(-1)


def white_ll_rel(cm, x0, r2):
    """Closure ``q -> ll(q) - ll(x0)`` per pulsar in float32, with the
    cancellation done per TOA before the sum (``z = N0/Nq``,
    ``0.5 (log z - w (z - 1))``, ``w = r2/N0``)."""
    fdt = cm.dtype
    N0f = cm.ndiag_fast(x0)
    w = r2.to(fdt) / N0f
    mask = cm.toa_mask

    def ll_rel(q):
        z = N0f / cm.ndiag_fast(q)
        return 0.5 * (mask * (torch.log(z) - w * (z - 1.0))).sum(-1)

    return ll_rel


def white_block_ll(cm, x, r, r2):
    """The white MH block's target (diagonal N)."""
    return white_ll_rel(cm, x, r2)


def _mh_step(cm, lnlike, ind):
    """One single-site Metropolis step with the scale-mixture proposal,
    jump sd tied to the coordinate's prior width; returns
    ``step(carry, noise)`` with ``noise = (scale, jpos, eps, logu)``
    (jpos indexes ``ind``)."""
    ind = torch.as_tensor(np.asarray(ind), dtype=torch.int64,
                          device=cm.device)
    prop = cm.prop_scale.to(cm.cdtype)

    def step(carry, noise):
        x, ll0, lp0 = carry
        scale, jpos, eps, logu = noise
        j = ind[jpos]
        q = x.scatter_add(-1, j[..., None],
                          (eps * prop[j] * scale)[..., None])
        lp1 = cm.lnprior(q)
        ll1 = lnlike(q)
        ok = torch.isfinite(lp1) & torch.isfinite(ll1)
        logr = torch.where(ok, (ll1 + lp1) - (ll0 + lp0),
                           torch.full_like(ll1, -math.inf))
        acc = logr > logu
        x = torch.where(acc[..., None], q, x)
        ll0 = torch.where(acc, ll1, ll0)
        lp0 = torch.where(acc, lp1, lp0)
        return (x, ll0, lp0), x[..., ind]

    return step


def mh_scan_core(cm, x, lnlike, ind, scale, jpos, eps, logu):
    """Fixed-length single-site MH sub-chain over coordinates ``ind``;
    the noise arrays lead with the step axis.  Returns ``(x', rec)``,
    ``rec`` (steps, ..., len(ind))."""
    step = _mh_step(cm, lnlike, ind)
    carry = (x, lnlike(x), cm.lnprior(x))
    rec = []
    for s in range(scale.shape[0]):
        carry, r = step(carry, (scale[s], jpos[s], eps[s], logu[s]))
        rec.append(r)
    return carry[0], torch.stack(rec)


def mh_scan(cm, x, gen, lnlike, ind, nsteps):
    """:func:`mh_scan_core` with its noise drawn from ``gen``."""
    cdt, dev = cm.cdtype, cm.device
    shape = (nsteps,) + x.shape[:-1]
    scale = _scale_choice(gen, shape, cdt, dev)
    jpos = torch.randint(0, len(ind), shape, generator=gen, device=dev)
    eps = _normal(gen, shape, cdt, dev)
    logu = torch.log(_uniform(gen, shape, cdt, dev))
    return mh_scan_core(cm, x, lnlike, ind, scale, jpos, eps, logu)


def parallel_cov_mh_scan_core(cm, x, ll_per_fn, par_ix, nper, chol,
                              scale, z, logu, coin=None, record=True,
                              mode=None, asqrt=None, inflate=1.3):
    """Per-pulsar full-block MH with adapted proposals (float32), mixing
    a random walk ``x_p + scale (2.38/sqrt(W_p)) L_p z`` with, when
    ``mode`` is given, an independence proposal ``mode_p + inflate L_p
    z`` accepted with its Hastings ratio.

    Noise (steps lead): ``scale`` (S, ..., P), ``z`` (S, ..., P, W),
    ``logu`` (S, ..., P), ``coin`` (S, ..., P) bool (independence
    choice).  ``chol``/``asqrt`` (..., P, W, W), ``mode`` (..., P, W).
    Returns ``(x', rec)`` with ``rec`` (..., S, P, W) or None."""
    fdt = cm.dtype
    W = par_ix.shape[1]
    wmask = (torch.arange(W, device=cm.device)[None, :]
             < nper[:, None]).to(fdt)
    live = nper > 0
    amp = 2.38 / torch.sqrt(torch.clamp(nper, min=1).to(fdt))
    safe_ix = torch.clamp(par_ix, max=cm.nx - 1)
    chol = chol.to(fdt)
    Lz = torch.matmul(chol, z[..., None])[..., 0] * wmask
    noise = Lz * (amp[:, None] * scale[..., None])
    if mode is not None:
        mode = mode.to(fdt)
        asq = asqrt.to(fdt) / inflate

        def logg(w):
            v = ((w - mode) * wmask)[..., None]
            uu = torch.matmul(asq.transpose(-1, -2), v)[..., 0]
            return -0.5 * (uu * uu).sum(-1)

    ll0 = ll_per_fn(x)
    rec = []
    for s in range(scale.shape[0]):
        xw = x[..., safe_ix].to(fdt)
        nz = noise[s]
        if mode is not None:
            nz_ind = (mode + inflate * Lz[s] - xw) * wmask
            nz = torch.where(coin[s][..., None], nz_ind, nz)
        qw = xw + nz
        dlp = (wmask * (cm.coord_logpdf(par_ix, qw)
                        - cm.coord_logpdf(par_ix, xw))).sum(-1)
        if mode is not None:
            dlp = dlp + torch.where(coin[s], logg(xw) - logg(qw),
                                    torch.zeros_like(dlp))
        q = _add_x(x, par_ix, nz)
        ll1 = ll_per_fn(q)
        ok = torch.isfinite(dlp) & torch.isfinite(ll1)
        logr = torch.where(ok, (ll1 - ll0) + dlp,
                           torch.full_like(ll1, -math.inf))
        acc = (logr > logu[s]) & live
        x = _add_x(x, par_ix, torch.where(acc[..., None], nz,
                                          torch.zeros_like(nz)))
        ll0 = torch.where(acc, ll1, ll0)
        if record:
            rec.append(x[..., safe_ix])
    if not record:
        return x, None
    return x, torch.stack(rec, dim=-3)


def parallel_cov_mh_scan(cm, x, gen, ll_per_fn, par_ix, nper, chol, nsteps,
                         record=True, mode=None, asqrt=None, p_indep=0.5,
                         inflate=1.3):
    """:func:`parallel_cov_mh_scan_core` with its noise drawn from
    ``gen``."""
    fdt, dev = cm.dtype, cm.device
    P, W = par_ix.shape
    shape = (nsteps,) + x.shape[:-1] + (P,)
    scale = _scale_choice(gen, shape, fdt, dev)
    z = _normal(gen, shape + (W,), fdt, dev)
    logu = torch.log(_uniform(gen, shape, fdt, dev))
    coin = None
    if mode is not None:
        coin = _uniform(gen, shape, fdt, dev) < p_indep
    return parallel_cov_mh_scan_core(
        cm, x, ll_per_fn, par_ix, nper, chol, scale, z, logu, coin=coin,
        record=record, mode=mode, asqrt=asqrt, inflate=inflate)


def _prior_halfwidth2(cm):
    """(nx,) squared prior half-widths (normal: 2 sd)."""
    pb = cm.pb.to(torch.float64)
    pa = cm.pa.to(torch.float64)
    w = torch.where(cm.pkind == 1, 2.0 * pb, torch.abs(pb - pa))
    return (0.5 * w) ** 2


def _block_eigh(A):
    """Batched symmetric eigendecomposition of the small (W x W)
    curvature blocks on ``A``'s device.  A block with a non-finite entry
    gets NaN eigenvalues and vectors, as ``jnp.linalg.eigh`` gives it in
    the JAX package, so its Newton steps and MH proposals are all
    rejected; the solver sees the identity in its place, because the
    card's batched Jacobi solver reports such a block as not converged
    and ``torch.linalg.eigh`` then raises for the whole batch."""
    bad = ~torch.isfinite(A).all(-1).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    e, V = torch.linalg.eigh(torch.where(bad[..., None, None], eye, A))
    nan = torch.full((), math.nan, dtype=A.dtype, device=A.device)
    return (torch.where(bad[..., None], nan, e),
            torch.where(bad[..., None, None], nan, V))


def laplace_newton_chol(cm, x, ll_per_fn, par_ix, nper, newton_iters=8):
    """Per-pulsar Laplace proposal square roots for a factorized MH
    block: a few damped saddle-free Newton steps to each block's
    conditional mode, then the eigendecomposition of the negative block
    Hessian (``W`` Hessian-vector products through ``torch.func``,
    shared by all pulsars and chains; see :func:`_block_eigh` for a
    non-finite block), eigenvalues floored so no proposal sd
    exceeds half the prior width.

    Returns ``(x_at_mode, L, asqrt)``: ``L = V diag(1/sqrt(e))``,
    ``asqrt = V diag(sqrt(e))``, both (..., P, W, W), pad rows zero."""
    from torch.func import grad, jvp

    P, W = par_ix.shape
    cdt = cm.cdtype
    safe_ix = torch.clamp(par_ix, max=cm.nx - 1)
    wmask = torch.arange(W, device=cm.device)[None, :] < nper[:, None]
    live = nper > 0
    hw2 = _prior_halfwidth2(cm).to(cdt)[safe_ix]
    vmax = torch.where(wmask, hw2, torch.full_like(hw2, 1e-30)).amax(-1)
    pk = cm.pkind[safe_ix]
    a = cm.pa.to(cdt)[safe_ix]
    b_ = cm.pb.to(cdt)[safe_ix]
    lo = torch.where(pk == 1, a - 8.0 * b_, a)
    hi = torch.where(pk == 1, a + 8.0 * b_, b_)
    margin = 1e-6 * (hi - lo)
    lo, hi = lo + margin, hi - margin

    x = x.to(cdt)
    theta0 = x[..., safe_ix]
    eyeW = torch.eye(W, dtype=cdt, device=cm.device)

    def q_of(theta):
        return _set_x(x, par_ix, torch.where(wmask, theta, theta0))

    def f_sum(theta):
        return ll_per_fn(q_of(theta)).to(cdt).sum()

    grad_f = grad(f_sum)

    def decomp(theta):
        cols = [jvp(grad_f, (theta,), (eyeW[w].expand(theta.shape),))[1]
                for w in range(W)]
        H = torch.stack(cols, dim=-1)
        A = -0.5 * (H + H.transpose(-1, -2))
        mo = wmask[:, :, None] & wmask[:, None, :]
        A = (torch.where(mo, A, torch.zeros_like(A))
             + torch.where(wmask, 0.0, 1.0).to(cdt)[:, :, None] * eyeW)
        return _block_eigh(A)

    def newton_body(theta):
        g = grad_f(theta)
        e, V = decomp(theta)
        e = torch.maximum(torch.abs(e), 1.0 / vmax[:, None])
        Vg = torch.matmul(V.transpose(-1, -2), g[..., None])[..., 0]
        step = torch.matmul(V, (Vg / e)[..., None])[..., 0]
        best = ll_per_fn(q_of(theta))
        out = theta
        for alpha in (1.0, 0.25):
            cand = torch.clamp(theta + alpha * step, lo, hi)
            llc = ll_per_fn(q_of(cand))
            better = (llc > best) & live
            out = torch.where(better[..., None], cand, out)
            best = torch.where(better, llc, best)
        return out

    theta = theta0
    for _ in range(newton_iters):
        theta = newton_body(theta)
    e, V = decomp(theta)
    e = torch.maximum(e, 1.0 / vmax[:, None])
    mo = (wmask[:, :, None] & wmask[:, None, :]).to(cdt)
    L = (V * (1.0 / torch.sqrt(e))[..., None, :]) * mo
    asqrt = (V * torch.sqrt(e)[..., None, :]) * mo
    return q_of(theta), L, asqrt


# ===========================================================================
# hyper block
# ===========================================================================

def _rho_grid(cm, lo, hi):
    """Log-uniform variance grid in the storage dtype."""
    return torch.pow(10.0, torch.linspace(
        math.log10(lo), math.log10(hi), settings.rho_grid_size,
        dtype=cm.dtype, device=cm.device))


def _grid_logpdf(ltau, lother, grid):
    """``r - e^r`` with ``r = log tau - log(other + rho)`` on the grid."""
    logratio = ltau[..., None] - torch.logaddexp(lother[..., None],
                                                 torch.log(grid))
    return logratio - torch.exp(logratio)


def rho_update_core(cm, x, b, gumbel):
    """Common free-spectrum log10_rho draw: per-pulsar log-PDF grids
    summed over the pulsar axis, then Gumbel-max sampled.  ``gumbel``
    (..., K, R) in the storage dtype."""
    if cm.K == 0 or len(cm.rho_ix_x) == 0:
        return x
    if cm.P_real == 1 and cm.red_kind == "":
        raise NotImplementedError(
            "the single-pulsar inverse-CDF rho draw is not in the port yet")
    fdt = cm.dtype
    grid = _rho_grid(cm, cm.rhomin, cm.rhomax)
    ltau = torch.log(cm.gw_tau(b)).to(fdt)
    lother = torch.log(cm.red_phi(x)).to(fdt)
    logpdf = _grid_logpdf(ltau, lother, grid)
    # mask by where, not multiply: a pad pulsar's log tau is -inf
    logpdf = torch.where(cm.psr_mask[:, None, None] > 0, logpdf,
                         torch.zeros((), dtype=fdt, device=cm.device))
    logpdf = logpdf.sum(-3)
    rhonew = grid[torch.argmax(logpdf + gumbel, dim=-1)]
    x = x.clone()
    x[..., cm.rho_ix_x] = (0.5 * torch.log10(rhonew)).to(x.dtype)
    return x


def rho_update(cm, x, b, gen):
    """:func:`rho_update_core` with its Gumbels drawn from ``gen``."""
    shape = x.shape[:-1] + (cm.K, settings.rho_grid_size)
    return rho_update_core(cm, x, b, _gumbel(gen, shape, cm.dtype,
                                             cm.device))


def red_conditional_update_core(cm, x, b, gumbel):
    """Per-pulsar intrinsic red free-spectrum grid draw with the common
    process as the 'other' variance; ``gumbel`` (..., P, Kr, R)."""
    fdt = cm.dtype
    grid = _rho_grid(cm, cm.red_rhomin, cm.red_rhomax)
    ltau = torch.log(cm.red_tau(b)).to(fdt)
    lother = torch.log(cm.gw_phi_at_red(x)).to(fdt)
    logpdf = _grid_logpdf(ltau, lother, grid)
    rhonew = grid[torch.argmax(logpdf + gumbel, dim=-1)]
    return _set_x(x, cm.red_rho_ix_x, 0.5 * torch.log10(rhonew))


def red_conditional_update(cm, x, b, gen):
    """:func:`red_conditional_update_core` with Gumbels from ``gen``."""
    shape = x.shape[:-1] + tuple(cm.red_rho_ix_x.shape) + (
        settings.rho_grid_size,)
    return red_conditional_update_core(
        cm, x, b, _gumbel(gen, shape, cm.dtype, cm.device))


def _rho_scale_applies(cm) -> bool:
    """CRN free-spectrum common block with a sampled rho (diagonal N)."""
    return (cm.orf_name == "crn" and cm.gw_kind == "free_spectrum"
            and bool(cm.K) and len(cm.rho_ix_x) > 0)


def rho_scale_moves_core(cm, x, b, u, eps, logu):
    """Interweaving scale moves along the rho <-> b funnel: per frequency
    k, jointly propose ``rho_k -> e^z rho_k`` and ``b_pk -> e^(z/2) b_pk``
    on the shared columns (``z = RHO_SCALE_SIGMA * eps[..., k]``),
    Metropolis-accepted with the exact joint density ratio and the
    Jacobian ``e^(z n/2)``.  ``eps``/``logu`` (..., K) float64.  Returns
    ``(x, b, u)`` with ``u = T b`` updated in place of a new matvec."""
    cdt, fdt = cm.cdtype, cm.dtype
    B, P, K = cm.Bmax, cm.P, cm.K
    live = cm.psr_mask.to(cdt)
    redv = cm.red_phi(x)
    invN = cm.toa_mask / cm.ndiag_fast(x)
    lo, hi = math.log(cm.rhomin), math.log(cm.rhomax)
    pr = torch.arange(P, device=cm.device)
    x, b = x.clone(), b.clone()
    for k in range(K):
        z = RHO_SCALE_SIGMA * eps[..., k]
        gs, gc = cm.gw_sin_ix[:, k], cm.gw_cos_ix[:, k]
        sk = torch.clamp(gs, 0, B - 1)
        ck = torch.clamp(gc, 0, B - 1)
        vs = ((gs >= 0) & (gs < B)).to(cdt) * live
        vc = ((gc >= 0) & (gc < B)).to(cdt) * live
        bs = _take_cols(b, sk) * vs
        bc = _take_cols(b, ck) * vc
        Ts = cm.T[pr, :, sk]
        Tc = cm.T[pr, :, ck]
        t = Ts * bs.to(fdt)[..., None] + Tc * bc.to(fdt)[..., None]
        delta = (torch.exp(0.5 * z) - 1.0).to(fdt)
        r = cm.y - u
        dll = (delta * (r * t * invN).sum((-2, -1))
               - 0.5 * delta * delta * (t * t * invN).sum((-2, -1)))
        rix = cm.rho_ix_x[k]
        lrho = 2.0 * _LN10 * x[..., rix].to(cdt)
        rho = torch.exp(lrho)
        tau = 0.5 * (bs * bs + bc * bc)
        ez = torch.exp(z)
        other = redv[..., min(k, K - 1)]
        phi0 = rho[..., None] + other
        phi1 = (ez * rho)[..., None] + other
        nv = vs + vc
        dlp = torch.where(
            nv > 0,
            -(ez[..., None] * tau / phi1 - tau / phi0)
            - 0.5 * nv * (torch.log(phi1) - torch.log(phi0)),
            torch.zeros((), dtype=cdt, device=cm.device)).sum(-1)
        njac = 0.5 * nv.sum() * z
        inb = (lrho + z > lo) & (lrho + z < hi)
        logr = torch.where(inb, dll.to(cdt) + dlp + njac,
                           torch.full_like(dlp, -math.inf))
        acc = logr > logu[..., k]
        scale = torch.where(acc, torch.exp(0.5 * z),
                            torch.ones_like(z))[..., None]
        for ix, v in ((sk, vs), (ck, vc)):
            cur = _take_cols(b, ix)
            new = torch.where(v > 0, cur * scale, cur)
            b = b.scatter(-1, ix[:, None].expand(b.shape[:-1] + (1,)),
                          new[..., None])
        u = torch.where(acc[..., None, None], u + delta[..., None, None] * t,
                        u)
        step = (0.5 / _LN10 * z).to(x.dtype)
        x[..., rix] = torch.where(acc, x[..., rix] + step, x[..., rix])
    return x, b, u


def rho_scale_moves(cm, x, b, u, gen):
    """:func:`rho_scale_moves_core` with its noise drawn from ``gen``."""
    shape = x.shape[:-1] + (cm.K,)
    eps = _normal(gen, shape, cm.cdtype, cm.device)
    logu = torch.log(_uniform(gen, shape, cm.cdtype, cm.device))
    return rho_scale_moves_core(cm, x, b, u, eps, logu)
