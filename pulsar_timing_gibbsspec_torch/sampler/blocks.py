"""Gibbs blocks of the port's sweeps, batched over chains.

Port of the sweep's pieces of ``pulsar_timing_gibbsspec_tpu/sampler/
jax_backend.py``: the segmented Grams and the b-draws (steady
Metropolised draw, refresh, exact draw; under a correlated ORF the
structured two-stage joint draw over all pulsars, with its dense
reference, and the pulsar-wise and frequency-block sweeps of
``PTGIBBS_HD_KERNEL``), the white-noise and ECORR blocks (relative
likelihoods, adapted full-block MH, Laplace proposals; basis ECORR on
its coefficients, kernel ECORR through the Woodbury form of the block
N),
the hyper blocks (common-rho grid draw, its correlated-ORF form on the
quadratic form of the common coefficients, or the single-pulsar
inverse-CDF draw; per-pulsar free-spectrum red draw; the t-process
alpha draw; rho <-> b scale moves; the powerlaw hyper MH block with its
b-conditional and b-marginalized likelihoods; the sampled ORF weights'
b-conditional likelihood) and the facade's sampling-flag check.  Every
function takes the chains as leading dimensions of ``x`` (``(C, nx)``), ``b`` (``(C, P, Bmax)``)
and ``u = T b`` (``(C, P, Nmax)``); the kernels see ``C * P`` systems at
once.

Each stochastic block is split: ``*_core`` takes its noise as tensors
(normals, log-uniforms, Gumbels, drawn as the JAX function draws them),
and the wrapper of the same name without the suffix draws that noise
from an explicit ``torch.Generator``.  The tests feed the JAX-drawn noise
to the cores.  Numerics constants are the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import current_settings, settings
from ..ops import kernels
from ..ops.linalg import (_batched_diag, _mm, _mm_t, _mv, _t,
                          block_grid_cholinv,
                          block_grid_solve_lower, block_grid_solve_upper,
                          block_grid_to_dense, blocked_chol_inv,
                          mvn_conditional_draw, tf_chol_factor, tf_mm)
from ..parallel import sharding

_SCALES = (0.1, 0.5, 1.0, 3.0, 10.0)
_SCALE_P = (0.1, 0.15, 0.5, 0.15, 0.1)
#: sweeps between Metropolised near-exact refreshes of the b-draw
EXACT_EVERY = 16
#: ridge on the float32-preconditioned proposal system
_PROP_RIDGE = 4e-6
#: step scale (natural log of the variance ratio) of the rho <-> b moves
RHO_SCALE_SIGMA = 0.65
_LN10 = math.log(10.0)
#: at or below this many common-process coordinates (2K P) the joint
#: draw's Schur complement is factored flat, above it block by block
SCHUR_DENSE_MAX = 128
#: at or below this many coefficients (P Bmax) a correlated ORF's b-draw
#: is the structured joint draw whatever ``PTGIBBS_HD_KERNEL`` asks: the
#: pulsar-wise and frequency-block sweeps apply past it
HD_DENSE_MAX = 64
#: log10 bounds and size of the t-process alpha grid: the InvGamma(1, 1)
#: prior holds nearly all its mass in [1e-4, 1e4] and the likelihood
#: tail decays as alpha^-2 past tau / plaw
TP_ALPHA_LOG10_MIN, TP_ALPHA_LOG10_MAX, TP_ALPHA_GRID = -4.0, 10.0, 1000
#: points of the red quadrature of the partially collapsed common-rho
#: draw (log-spaced over [red_rhomin, red_rhomax], ~0.1 dex apart)
RHO_COLLAPSE_J = 64
#: the largest intermediate the collapsed draw makes, in bytes: its
#: (chains, pulsars, grid, quadrature) profile is formed in grid chunks
RHO_COLLAPSE_CHUNK_BYTES = 128 << 20


# ===========================================================================
# sampling flags
# ===========================================================================

def validate_sampling_flags(cm, hypersample=None, ecorrsample=None,
                            redsample=None):
    """The reference's block-kernel selectors, checked against the model
    (``cm.param_names``) as the JAX package checks them: ``None`` means
    the kernel follows the model; an explicit value that asks for a
    kernel the model cannot take raises."""
    names = list(cm.param_names)
    has_red_rho = any("rho" in n and "red" in n for n in names)
    has_red_pl = any(("log10_A" in n or "gamma" in n) and "red" in n
                     for n in names)
    if hypersample not in (None, "conditional"):
        raise NotImplementedError(
            f"hypersample={hypersample!r}: the common free-spectrum block "
            "is sampled by its exact conditional (inverse-CDF / Gumbel-max "
            "grid); an MH alternative is not implemented")
    if ecorrsample == "kernel":
        if not any("ecorr" in n for n in names):
            raise ValueError(
                "ecorrsample='kernel' but the model has no ECORR "
                "parameters (need white_vary=True on NANOGrav-flagged "
                "data with a backend selection)")
    elif ecorrsample not in (None, "mh"):
        raise NotImplementedError(
            f"ecorrsample={ecorrsample!r}: ECORR amplitudes are sampled by "
            "adapted-proposal MH on the basis representation, or by the "
            "in-N Woodbury kernel with ecorrsample='kernel'; other "
            "kernels are not implemented")
    if redsample == "conditional" and has_red_pl and not has_red_rho:
        raise NotImplementedError(
            "redsample='conditional' but the intrinsic red process has "
            "powerlaw-family hypers, which only the adaptive-MH block "
            "samples; build the model with red_psd='spectrum' for "
            "conditional red draws")
    if redsample == "mh" and has_red_rho:
        raise NotImplementedError(
            "redsample='mh' but the intrinsic red process is a free "
            "spectrum, which is sampled by its exact per-pulsar "
            "conditional; an MH alternative is not implemented")
    if redsample not in (None, "mh", "conditional"):
        raise NotImplementedError(f"redsample={redsample!r} is not known")


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


def _draw(cm, fn, shape, c_axis=None, p_axis=None):
    """``fn(shape)`` for a model shard (:func:`..parallel.sharding.
    draw`): the draw is made at the logical chain and pulsar counts of
    axes ``c_axis`` and ``p_axis`` of the local ``shape`` and this rank's
    rows are kept, so a sharded sweep draws the unsharded one's noise;
    ``fn(shape)`` itself on one model."""
    return sharding.draw(cm.shard, fn, shape, c_axis, p_axis)


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

def _flat_ix(ix, lead, vals):
    """``ix`` flattened over its value axes and broadcast to ``lead``:
    the axes of ``ix`` beyond those of one state's ``vals`` lead, and are
    a tenant stack's tenant axis (matched to the last of ``lead``)."""
    nt = ix.dim() - (vals.dim() - len(lead))
    return ix.reshape(ix.shape[:nt] + (-1,)).expand(lead + (-1,))


def _set_x(x, ix, vals):
    """``x.at[ix].set(vals, mode="drop")`` over the last axis: ``ix``
    (P, W) (a tenant stack's (T, P, W)) indexes x's last axis, pads point
    at ``nx`` and are dropped."""
    nx = x.shape[-1]
    lead = x.shape[:-1]
    flat = _flat_ix(ix, lead, vals)
    ext = torch.cat([x, x.new_zeros(lead + (1,))], -1)
    ext = ext.scatter(-1, flat, vals.reshape(lead + (-1,)).to(x.dtype))
    return ext[..., :nx]


def _add_x(x, ix, vals):
    """``x.at[ix].add(vals, mode="drop")`` over the last axis."""
    nx = x.shape[-1]
    lead = x.shape[:-1]
    flat = _flat_ix(ix, lead, vals)
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
    """``Ta = [T | y]`` (P, nseg, m, B1) with the TOA axis split into
    equal segments (pad TOA rows zero) and ``N`` (..., P, Nmax) in the
    storage dtype; a tenant stack's ``Ta`` is (T P, nseg, m, B1), each
    tenant's pulsars in a run, so that row ``b`` of ``N`` flattened
    meets its own tenant's basis.  ``TNa = Ta / N`` is never formed here:
    the kernel forms it on chip, and only the plain version materializes
    it (``kernels.reference.gram_operand``)."""
    Ta = torch.cat([cm.T, cm.y[..., None]], dim=-1)
    Ta = Ta.reshape((-1,) + Ta.shape[-2:])
    P, N, B1 = Ta.shape
    nseg = max(1, -(-N // seg_len))
    m = -(-N // nseg)
    if nseg * m != N:
        Ta = torch.nn.functional.pad(Ta, (0, 0, 0, nseg * m - N))
    return Ta.reshape(P, nseg, m, B1), Nvec.to(cm.dtype)


def _gram(cm, Nvec, seg_len, out_dtype, widen):
    Ta, N = _gram_operands(cm, Nvec, seg_len)
    lead = N.shape[:-1]
    G = kernels.gram_accumulate(Ta, N.reshape(-1, N.shape[-1]),
                                out_dtype=out_dtype, widen=widen)
    G = G.reshape(lead + G.shape[-2:])
    return G[..., :cm.Bmax, :cm.Bmax], G[..., :cm.Bmax, cm.Bmax]


def tnt_d(cm, Nvec, seg_len=None):
    """``(T^T N^-1 T, T^T N^-1 y)`` with exact (compute-dtype)
    accumulation of the storage-dtype operands, segments of
    ``cm.gram_seg_len_exact`` TOAs reduced in order."""
    return _gram(cm, Nvec, seg_len or cm.gram_seg_len_exact, cm.cdtype,
                 True)


def tnt_d_seg(cm, Nvec, seg_len=None):
    """Storage-dtype segment products (of ``cm.gram_seg_len`` TOAs)
    reduced in the compute dtype (the refresh Gram)."""
    return _gram(cm, Nvec, seg_len or cm.gram_seg_len, cm.cdtype, False)


def tnt_d_seg32(cm, Nvec, seg_len=None):
    """Storage-dtype segmented Gram, reduced in the storage dtype (the
    steady proposal Gram; all-float32 under float32 storage)."""
    return _gram(cm, Nvec, seg_len or cm.gram_seg_len, cm.dtype, False)


# ---- kernel ECORR: N = D + U c U^T, disjoint epochs --------------------
#
# The Woodbury pieces are plain PyTorch, as the JAX package computes them
# in XLA outside its Pallas kernels; the Gram under them is the widening
# float64 kernel.  Epoch sums are products with the one-hot indicators
# ``cm.ke_U`` (a fixed order of summation on every device, where an
# atomic scatter-add would not be); TOAs outside every epoch and pads
# have no row.

def ke_segsum(cm, vals, columns=False):
    """Sum ``vals`` (..., P, Nmax) per ECORR epoch -> (..., P, Emax), or
    with ``columns`` ``vals`` (..., P, Nmax, k) -> (..., P, Emax, k), in
    the compute dtype."""
    v = vals.to(cm.cdtype)
    if columns:
        return torch.matmul(cm.ke_U, v)
    return torch.matmul(cm.ke_U, v[..., None])[..., 0]


def ke_weights(cm, x, Nvec):
    """Per-epoch Woodbury pieces ``(c, s, w)``, each (..., P, Emax) in
    the compute dtype: ``c_e = 10^(2 log10_ecorr)``, ``s_e = sum_(i in
    e) 1/D_i``, ``w_e = c_e / (1 + c_e s_e)``, so that ``N^-1 = D^-1 -
    w_e (D^-1 1_e)(D^-1 1_e)^T`` per block and ``log det N = sum log D +
    sum log1p(c_e s_e)``.  A dummy epoch has ``c = 10^-80``, so ``w`` is
    1e-80 (in float64 it does not underflow to 0) and its epoch holds no
    TOA."""
    cdt = cm.cdtype
    c = torch.pow(10.0, 2.0 * cm.xe(x)[..., cm.ke_par_ix])
    invN = cm.toa_mask.to(cdt) / Nvec.to(cdt)
    s = ke_segsum(cm, invN)
    w = c / (1.0 + c * s)
    return c, s, w


def tnt_d_ke(cm, Nvec, w):
    """Kernel-ECORR :func:`tnt_d`: ``T^T N^-1 T`` and ``T^T N^-1 y`` of
    the block N, the diagonal Gram minus the Woodbury correction ``V^T
    diag(w) V`` with ``V_e = sum_(i in e) [T | y]_i / D_i`` (``Ta / D``
    in the storage dtype, then the compute dtype, as the JAX package
    forms it), ``d``'s correction riding the last column."""
    cdt = cm.cdtype
    TNT, d = tnt_d(cm, Nvec)
    Ta = torch.cat([cm.T, cm.y[..., None]], dim=-1)
    TNa = (Ta / Nvec.to(cm.dtype)[..., None]).to(cdt)
    V = ke_segsum(cm, TNa, columns=True)                    # (..., P, E, B1)
    corr = torch.matmul(V.transpose(-1, -2) * w.to(cdt)[..., None, :], V)
    return (TNT - corr[..., :cm.Bmax, :cm.Bmax],
            d - corr[..., :cm.Bmax, cm.Bmax])


def tnt_d_x(cm, x, Nvec):
    """``(TNT, d)`` for the current state: diagonal N, or the
    kernel-ECORR block N when the model compiles in that mode."""
    if not cm.has_ke:
        return tnt_d(cm, Nvec)
    _, _, w = ke_weights(cm, x, Nvec)
    return tnt_d_ke(cm, Nvec, w)


def ke_ll_corr(cm, x, Nvec, z):
    """(..., P) Woodbury correction to a diagonal Gaussian log-density,
    ``-0.5 [sum_e log1p(c_e s_e) - sum_e w_e z_e^2]``, with ``z_e =
    sum_(i in e) r_i / D_i`` given."""
    c, s, w = ke_weights(cm, x, Nvec)
    return -0.5 * (torch.log1p(c * s).sum(-1) - (w * z * z).sum(-1))


def ke_rz(cm, Nvec, r):
    """(..., P, Emax) per-epoch ``z_e = sum r_i / D_i`` (compute dtype)."""
    cdt = cm.cdtype
    invN = cm.toa_mask.to(cdt) / Nvec.to(cdt)
    return ke_segsum(cm, r.to(cdt) * invN)


def b_matvec(cm, b):
    """``u = T b`` in the storage dtype, (..., P, Nmax)."""
    return torch.matmul(cm.T, b.to(cm.dtype)[..., None])[..., 0]


def residual_sq(cm, b):
    """``(y - T b)^2`` in the storage dtype."""
    r = cm.y - b_matvec(cm, b)
    return r * r


def _per_chain(beta, nd):
    """A per-chain ``beta`` (...,) shaped to broadcast against a tensor
    with ``nd`` more trailing axes."""
    return beta.reshape(beta.shape + (1,) * nd)


def tempered_ll(ll, beta):
    """The likelihood closure ``ll`` (q -> (..., P)) raised to the
    per-chain inverse temperature ``beta`` (...,) (parallel tempering,
    :mod:`.ensemble`); ``ll`` itself when ``beta`` is None."""
    if beta is None:
        return ll
    return lambda q: ll(q) * _per_chain(beta, 1)


def _logpi_b_per(cm, x, b, u, beta=None):
    """Per-pulsar ``log pi(b | x)`` up to b-independent constants, from
    ``u = T b``: ``-0.5 u^2/N + (y/N) u - 0.5 b^2/phi``; float32
    elementwise, float64 sums.  ``beta`` (...,) scales the likelihood
    term only (the b prior is untempered)."""
    N = cm.ndiag_fast(x)
    t1 = (-0.5 * u + cm.y) * (u / N) * cm.toa_mask
    if beta is not None:
        t1 = t1 * _per_chain(beta.to(cm.dtype), 2)
    phi32 = cm.phi(x, dtype=cm.dtype)
    bb = b.to(cm.dtype)
    t2 = -0.5 * bb * bb / phi32
    return (t1.to(cm.cdtype).sum(-1) + t2.to(cm.cdtype).sum(-1))


def _logpi_b_pair(cm, x, b_old, b_new, u_old, u_new, beta=None):
    """Both sides of the b MH ratio in one pass; ``(lpi_old,
    lpi_new)``, each (..., P) in the compute dtype (``beta`` as in
    :func:`_logpi_b_per`)."""
    N = cm.ndiag_fast(x)
    uu = torch.stack([u_old, u_new])
    t1 = (-0.5 * uu + cm.y) * (uu / N) * cm.toa_mask
    if beta is not None:
        t1 = t1 * _per_chain(beta.to(cm.dtype), 2)
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


def _log_ratio(cm, x, b, u, L, mean, dj, bp, z, w_dtype, beta=None):
    """Exact log Hastings ratio of proposal ``bp`` (drawn as ``mean +
    dj * Li^T z``) against the current ``b``, and ``up = T bp``."""
    up = b_matvec(cm, bp)
    lpi_old, lpi_new = _logpi_b_pair(cm, x, b, bp, u, up, beta)
    v = (b.to(w_dtype) - mean) / dj
    w_old = torch.matmul(L.transpose(-1, -2), v[..., None])[..., 0]
    logq_old = -0.5 * (w_old * w_old).sum(-1).to(cm.cdtype)
    logq_new = -0.5 * (z * z).sum(-1).to(cm.cdtype)
    return (lpi_new - lpi_old) + (logq_old - logq_new), up


def _accept(b, u, bp, up, logr, ok, logu):
    acc = ok & (logr > logu)
    return (torch.where(acc[..., None], bp, b),
            torch.where(acc[..., None], up, u), acc)


def _tempered_N(cm, x, beta):
    """``N`` in the storage dtype, ``N / beta`` per chain when tempered
    (the likelihood ``L^beta`` is Gaussian with that covariance)."""
    N = cm.ndiag_fast(x)
    if beta is None:
        return N
    return N / _per_chain(beta.to(N.dtype), 2)


def propose_b_mh(cm, x, b, u, z, beta=None):
    """The steady proposal: the float32-factored conditional (segmented
    float32 Gram, fused factor chain with the ``_PROP_RIDGE`` guard) at
    float32 normals ``z`` (..., P, Bmax).  Returns ``(bp, up, logr, ok,
    L, dj)``: proposal, its ``T bp``, the exact log Hastings ratio, the
    finiteness mask, and the preconditioned factor and scaling that
    whiten the proposal (``L^T (v / dj)`` is in proposal-sd units).
    ``beta`` (...,): the tempered conditional, ``N -> N / beta`` in the
    Gram and the likelihood term of the ratio scaled."""
    fdt = cm.dtype
    TNT, d = tnt_d_seg32(cm, _tempered_N(cm, x, beta))
    phi32 = cm.phi(x, dtype=fdt)
    eye = torch.eye(cm.Bmax, dtype=fdt, device=cm.device)
    Sig = TNT + (1.0 / phi32)[..., :, None] * eye
    L, Li, dj, mean, bp32 = _factor_batch(Sig, d, z, ridge=_PROP_RIDGE)
    bp = bp32.to(cm.cdtype)
    logr, up = _log_ratio(cm, x, b, u, L, mean, dj, bp, z, fdt, beta)
    ok = torch.isfinite(bp32).all(-1) & torch.isfinite(logr)
    return bp, up, logr, ok, L, dj


def draw_b_mh_core(cm, x, b, u, z, logu, beta=None):
    """Metropolised b-draw: the :func:`propose_b_mh` proposal accepted
    per pulsar with the exact Hastings ratio against ``logu`` (..., P)
    float64 log-uniforms.  Returns ``(b', u', accepted)``."""
    bp, up, logr, ok = propose_b_mh(cm, x, b, u, z, beta)[:4]
    return _accept(b, u, bp, up, logr, ok, logu)


def _b_noise(cm, gen, b, dtype):
    """The b-draws' normals (..., P, Bmax) in ``dtype`` and float64
    log-uniforms (..., P), chains and pulsars of a shard kept."""
    pa = b.dim() - 2
    z = _draw(cm, lambda s: _normal(gen, s, dtype, cm.device), b.shape,
              0, pa)
    logu = torch.log(_draw(cm, lambda s: _uniform(gen, s, cm.cdtype,
                                                  cm.device),
                           b.shape[:-1], 0, pa))
    return z, logu


def draw_b_mh(cm, x, b, u, gen, beta=None):
    """:func:`draw_b_mh_core` with its noise drawn from ``gen``."""
    z, logu = _b_noise(cm, gen, b, cm.dtype)
    return draw_b_mh_core(cm, x, b, u, z, logu, beta)


def propose_b_refresh(cm, x, b, u, z, beta=None):
    """The refresh proposal: the float32-segment/float64-reduce Gram
    factored by the two-float ``tf`` factor (ridge corrected) at float64
    normals ``z``.  Returns ``(bp, up, logr, ok, L, dj)`` as
    :func:`propose_b_mh` does (``beta`` as there)."""
    TNT, d = tnt_d_seg(cm, _tempered_N(cm, x, beta))
    phi = cm.phi(x)
    Sig = TNT + _batched_diag(1.0 / phi)
    L, Li, dj, mean, bp = _factor_batch(Sig, d, z, ridge=_PROP_RIDGE,
                                        factor="tf")
    logr, up = _log_ratio(cm, x, b, u, L, mean, dj, bp, z, cm.cdtype,
                          beta)
    ok = torch.isfinite(bp).all(-1) & torch.isfinite(logr)
    return bp, up, logr, ok, L, dj


def draw_b_refresh_core(cm, x, b, u, z, logu, beta=None):
    """Near-exact Metropolised refresh: the :func:`propose_b_refresh`
    proposal accepted with the exact Hastings ratio.  Returns ``(b',
    u', accepted)``."""
    bp, up, logr, ok = propose_b_refresh(cm, x, b, u, z, beta)[:4]
    return _accept(b, u, bp, up, logr, ok, logu)


def draw_b_refresh(cm, x, b, u, gen, beta=None):
    """:func:`draw_b_refresh_core` with its noise drawn from ``gen``."""
    z, logu = _b_noise(cm, gen, b, cm.cdtype)
    return draw_b_refresh_core(cm, x, b, u, z, logu, beta)


def draw_b_fn_core(cm, x, z, b=None):
    """Exact b | everything for the CRN model: float64-accumulated Gram,
    float64 blocked factor, ``mean + Sigma^-1/2 z`` with ``z`` (..., P,
    Bmax) float64 normals.  Under a correlated ORF: the structured joint
    draw in float64 (:func:`draw_b_joint_structured_core` with
    ``exact=True``), ``z`` (..., P Bmax + 2K P).

    A pulsar whose draw is not finite keeps its current ``b`` (zeros
    when none is given): the float32-rounded Gram loses positive
    definiteness at some warmup states (one backend's efac far below 1).
    That is the JAX package's guard on its joint draw ("skip the whole
    update rather than poison the chain", ``jax_backend.py:1099``); its
    CRN draw has none, and a NaN ``b`` there is never replaced: every
    later Metropolised draw rejects against it."""
    if cm.orf_name != "crn":
        return draw_b_joint_structured_core(cm, x, z, b, exact=True)[0]
    N = cm.ndiag_fast(x)
    TNT, d = tnt_d_x(cm, x, N)
    phi = cm.phi(x)
    bn, _ = mvn_conditional_draw(TNT, 1.0 / phi, d, z)
    if b is None:
        b = torch.zeros_like(bn)
    return torch.where(torch.isfinite(bn).all(-1, keepdim=True), bn, b)


def draw_b_fn(cm, x, gen, b=None):
    """:func:`draw_b_fn_core` with its noise drawn from ``gen``."""
    if cm.orf_name != "crn":
        z = _normal(gen, x.shape[:-1] + (_joint_dim(cm),), cm.cdtype,
                    cm.device)
    else:
        lead = x.shape[:-1]
        z = _draw(cm, lambda s: _normal(gen, s, cm.cdtype, cm.device),
                  lead + (cm.pn, cm.Bmax), 0, len(lead))
    return draw_b_fn_core(cm, x, z, b)


# ===========================================================================
# the correlated-ORF joint b-draw
# ===========================================================================
#
# With a correlated ORF the common process couples the pulsars through
# its columns alone: per (frequency, phase) group its prior over pulsars
# is rho_k G, so the joint precision carries G^-1 / rho_k there and stays
# diagonal elsewhere.  Both draws below factor one matrix, in one
# coordinate order: [P Bmax "local" slots, pulsar-major, the common
# columns replaced by inert identity coordinates | 2K P common slots,
# group-major (sin k = 0..K-1, cos k = 0..K-1; pulsar inner)].  Identity
# rows stay exactly decoupled under Cholesky, so every shape is static,
# and the dense and structured draws give the same sample for the same
# normals up to rounding.

def _joint_dim(cm):
    return cm.P * cm.Bmax + 2 * cm.K * cm.P


def _gather_last(a, ix):
    """``take_along_axis(a, ix, -1)`` with ``ix`` broadcast over ``a``'s
    leading dimensions."""
    return torch.gather(a, -1, ix.expand(a.shape[:-1] + ix.shape[-1:]))


def _scatter_drop(b, cols, vals):
    """``b.at[p, cols[p]].set(vals, mode="drop")``: ``cols`` (P, W),
    columns past ``Bmax`` dropped."""
    B = b.shape[-1]
    ext = torch.cat([b, b.new_zeros(b.shape[:-1] + (1,))], -1)
    idx = torch.clamp(cols, max=B).expand(vals.shape)
    return ext.scatter(-1, idx, vals.to(b.dtype))[..., :B]


def _joint_perm_parts(cm, x):
    """The pieces of the permuted joint system: ``(d, cols, valid, ccl,
    nm, Snn, Tg, Agg)``: the projected data of the segmented Gram
    (float32 segments, float64 reduce), the common columns
    (``cm.gw_cols_valid``), the non-common indicator ``nm`` (P, Bmax),
    the local block ``Snn`` (..., P, B, B) with the common rows and
    columns turned into identity, the local-common coupling strips
    ``Tg`` (..., P, B, 2K) (common rows zeroed) and the common-common
    Gram blocks ``Agg`` (..., P, 2K, 2K)."""
    cdt = cm.cdtype
    B, P = cm.Bmax, cm.P
    N = cm.ndiag_fast(x)
    # kernel-ECORR models keep the widening Gram under their correction
    TNT, d = tnt_d_x(cm, x, N) if cm.has_ke else tnt_d_seg(cm, N)
    pinv = 1.0 / cm.phi(x)
    cols, valid, ccl = cm.gw_cols_valid()
    gwm = torch.zeros((P, B), dtype=cdt, device=cm.device).scatter_reduce(
        1, ccl, valid, reduce="amax")
    nm = 1.0 - gwm
    eyeB = torch.eye(B, dtype=cdt, device=cm.device)
    Snn = ((TNT + (pinv * nm)[..., :, None] * eyeB) * nm[:, :, None]
           * nm[:, None, :] + gwm[:, :, None] * eyeB)
    # the strips gather through clipped indices: mask by valid
    Tcols = _gather_last(TNT, ccl[:, None, :]) * valid[:, None, :]
    Tg = Tcols * nm[:, :, None]
    Agg = torch.gather(Tcols, -2, ccl[:, :, None].expand(
        Tcols.shape[:-2] + (ccl.shape[1], ccl.shape[1]))) * valid[:, :, None]
    return d, cols, valid, ccl, nm, Snn, Tg, Agg


def _joint_gw_prior(cm, x, valid):
    """The common prior blocks ``G^-1 / rho_k`` per group (..., 2K, P, P),
    identity on invalid slots, and the ``rho`` (..., 2K) and ``G^-1_pp``
    ((..., )2K, P; per chain under sampled weights) the Schur diagonal
    needs: ``(Dg, rho2, Gpp)``."""
    cdt = cm.cdtype
    rho = torch.pow(10.0, 2.0 * x.to(cdt)[..., cm.rho_ix_x])
    Ginv = cm.orf_ginv_k(x)
    Gfull = torch.cat([Ginv, Ginv], dim=-3)
    rho2 = torch.cat([rho, rho], dim=-1)
    vg = valid.transpose(0, 1)
    eyeP = torch.eye(cm.P, dtype=cdt, device=cm.device)
    Dg = (Gfull / rho2[..., :, None, None] * vg[:, :, None] * vg[:, None, :]
          + (1.0 - vg)[:, :, None] * eyeP)
    Gpp = torch.diagonal(Gfull, dim1=-2, dim2=-1)
    return Dg, rho2, Gpp


def draw_b_joint(cm, x, z):
    """The dense joint draw: the whole permuted system assembled and
    factored at once, ``z`` (..., P Bmax + 2K P) float64 normals.  The
    reference the structured draw is held against; no sweep runs it."""
    cdt = cm.cdtype
    B, P, K = cm.Bmax, cm.P, cm.K
    PB, G = P * B, 2 * K
    n = PB + G * P
    lead = x.shape[:-1]
    d, cols, valid, ccl, nm, Snn, Tg, Agg = _joint_perm_parts(cm, x)
    Dg, _, _ = _joint_gw_prior(cm, x, valid)
    dev = cm.device
    lrows = (torch.arange(P, device=dev)[:, None] * B
             + torch.arange(B, device=dev)[None, :])
    garr = (PB + torch.arange(G, device=dev)[:, None] * P
            + torch.arange(P, device=dev)[None, :])
    gidx = garr.transpose(0, 1)
    Lam = torch.zeros(lead + (n, n), dtype=cdt, device=dev)
    Lam[..., lrows[:, :, None], lrows[:, None, :]] = Snn
    Lam[..., lrows[:, :, None], gidx[:, None, :]] = Tg
    Lam[..., gidx[:, :, None], lrows[:, None, :]] = Tg.transpose(-1, -2)
    Lam[..., gidx[:, :, None], gidx[:, None, :]] = Agg
    Lam[..., garr[:, :, None], garr[:, None, :]] += Dg
    dn = (d * nm).reshape(lead + (PB,))
    dgw = (_gather_last(d, ccl) * valid).transpose(-1, -2).reshape(
        lead + (G * P,))
    dvec = torch.cat([dn, dgw], dim=-1)
    dj = 1.0 / torch.sqrt(torch.diagonal(Lam, dim1=-2, dim2=-1))
    A = Lam * dj[..., :, None] * dj[..., None, :]
    _, Li = blocked_chol_inv(A)
    u = _mv(Li, dj * dvec)
    samp = dj * _mv(_t(Li), u + z)
    bloc = samp[..., :PB].reshape(lead + (P, B)) * nm
    bgw = samp[..., PB:].reshape(lead + (G, P)).transpose(-1, -2)
    return _scatter_drop(bloc, cols, bgw)


class JointFactors(NamedTuple):
    """Stage 1 of the structured joint draw, per pulsar: functions of
    ``N`` and the non-common phi alone (the white, ECORR and red blocks'
    coordinates), never of rho or b."""

    d: torch.Tensor        # (..., P, B) projected data
    cols: torch.Tensor     # (P, 2K) common columns
    valid: torch.Tensor    # (P, 2K) in-range indicator
    ccl: torch.Tensor      # (P, 2K) clipped gather indices
    nm: torch.Tensor       # (P, B) non-common indicator
    dj_n: torch.Tensor     # (..., P, B) local Jacobi scales
    Li1: torch.Tensor      # (..., P, B, B) inverse stage-1 factor
    Tg: torch.Tensor       # (..., P, B, 2K) local-common strips
    Agg: torch.Tensor      # (..., P, 2K, 2K) common-common Gram blocks
    mixed: bool            # the two-float factors were taken


def joint_factor_cache(cm, x, exact=False, mixed=None):
    """Stage 1: the batched factor of the P local blocks, float64
    (``blocked_chol_inv``) or, in mixed precision (``PTGIBBS_JOINT_MIXED``
    read now, unless ``mixed`` says) and not ``exact``, two-float
    (``tf_chol_factor``)."""
    if mixed is None:
        mixed = current_settings().joint_mixed
    use_tf = bool(mixed) and not exact
    d, cols, valid, ccl, nm, Snn, Tg, Agg = _joint_perm_parts(cm, x)
    dj_n = 1.0 / torch.sqrt(torch.diagonal(Snn, dim1=-2, dim2=-1))
    An = Snn * dj_n[..., :, None] * dj_n[..., None, :]
    _, Li1 = tf_chol_factor(An) if use_tf else blocked_chol_inv(An)
    return JointFactors(d=d, cols=cols, valid=valid, ccl=ccl, nm=nm,
                        dj_n=dj_n, Li1=Li1, Tg=Tg, Agg=Agg, mixed=use_tf)


def draw_b_joint_structured_core(cm, x, z, b=None, exact=False,
                                 factors=None, mixed=None):
    """The joint correlated-ORF b-draw in two stages, the production
    draw: the same conditional and the same sample for the same ``z``
    (..., P Bmax + 2K P) as :func:`draw_b_joint`, without the (P Bmax)^2
    system.

    1. per pulsar (:func:`joint_factor_cache`): the (P, B, B) batch of
       local blocks, the common coordinates inert;
    2. the Schur complement on the 2K P common coordinates as a (2K, 2K)
       grid of (P, P) blocks, ``S[g, h] = diag_p(Agg_p - C_p C_p^T)[g,
       h] + delta_gh G^-1 / rho_g`` with ``C_p`` the factor's panel,
       factored flat at or below ``SCHUR_DENSE_MAX`` coordinates and
       block by block (``block_grid_cholinv``) above;
    3. ``samp = D L^-T (L^-1 d + z)`` through both stages.

    In mixed precision both stages factor in two-float and the products
    run ``tf_mm``; a chain whose draw is not finite (a two-float
    breakdown) keeps its ``b`` (zeros when none is given) wholesale.
    ``exact=True`` factors in float64.  Returns ``(b', ok)``, ``ok``
    (...,) the chains whose draw was taken."""
    cdt = cm.cdtype
    B, P, K = cm.Bmax, cm.P, cm.K
    PB, G = P * B, 2 * K
    lead = x.shape[:-1]
    f = (joint_factor_cache(cm, x, exact=exact, mixed=mixed)
         if factors is None else factors)
    mm = tf_mm if f.mixed else _mm_t
    factor = tf_chol_factor if f.mixed else blocked_chol_inv

    # ---- stage 2: the Schur complement on the common coordinates --------
    Dg, rho2, Gpp = _joint_gw_prior(cm, x, f.valid)
    diag_g = (torch.diagonal(f.Agg, dim1=-2, dim2=-1)
              + torch.where(f.valid > 0, Gpp.transpose(-1, -2)
                            / rho2[..., None, :], 1.0))
    dj_g = 1.0 / torch.sqrt(diag_g)                           # (..., P, 2K)
    Bhat = (f.Tg.transpose(-1, -2) * dj_g[..., :, :, None]
            * f.dj_n[..., :, None, :])                        # (..., P, 2K, B)
    C = mm(Bhat, f.Li1, transpose_b=True)
    CCt = mm(C, C, transpose_b=True)                          # (..., P, 2K, 2K)
    Agg_hat = f.Agg * dj_g[..., :, :, None] * dj_g[..., :, None, :]
    dj_gT = dj_g.transpose(-1, -2)                            # (..., 2K, P)
    Dg_hat = Dg * dj_gT[..., :, :, None] * dj_gT[..., :, None, :]
    M = Agg_hat - CCt
    gr = torch.arange(G, device=cm.device)
    S = torch.diag_embed(M.movedim(-3, -1))                   # (..., G, G, P, P)
    S[..., gr, gr, :, :] = S[..., gr, gr, :, :] + Dg_hat

    # ---- solves and the sample ------------------------------------------
    dn_hat = f.dj_n * (f.d * f.nm)
    dg_hat = dj_g * (_gather_last(f.d, f.ccl) * f.valid)
    v_n = _mv(f.Li1, dn_hat)
    r_g = dg_hat - _mv(C, v_n)                                # (..., P, 2K)
    z_n = z[..., :PB].reshape(lead + (P, B))
    z_g = z[..., PB:].reshape(lead + (G, P))
    # inner Jacobi scaling of the Schur matrix: chol(D S D) = D chol(S),
    # so the sample map is unchanged in exact arithmetic
    sdiag = torch.diagonal(S[..., gr, gr, :, :], dim1=-2, dim2=-1)
    sj = 1.0 / torch.sqrt(sdiag)                              # (..., G, P)
    rg = r_g.transpose(-1, -2)
    if G * P <= SCHUR_DENSE_MAX:
        sjf = sj.reshape(lead + (G * P,))
        As = block_grid_to_dense(S) * sjf[..., :, None] * sjf[..., None, :]
        _, Lsi = factor(As)
        v_g = _mv(Lsi, sjf * rg.reshape(lead + (G * P,))).reshape(
            lead + (G, P))
        w_g = sj * _mv(_t(Lsi), (v_g + z_g).reshape(
            lead + (G * P,))).reshape(lead + (G, P))
    else:
        Ssc = S * sj[..., :, None, :, None] * sj[..., None, :, None, :]
        _, Ldi, Loff = block_grid_cholinv(Ssc, factor=factor, mm=mm)
        v_g = block_grid_solve_lower(Ldi, Loff, sj * rg)
        w_g = sj * block_grid_solve_upper(Ldi, Loff, v_g + z_g)
    # back through the panel to the local coordinates
    w_gT = w_g.transpose(-1, -2)                              # (..., P, 2K)
    t_n = v_n + z_n - _mv(_t(C), w_gT)
    w_n = _mv(_t(f.Li1), t_n)
    bnew = _scatter_drop(f.dj_n * w_n * f.nm, f.cols, dj_g * w_gT)
    if b is None:
        b = torch.zeros_like(bnew)
    ok = torch.isfinite(bnew).all(-1).all(-1)
    return torch.where(ok[..., None, None], bnew, b), ok


def draw_b_joint_structured(cm, x, gen, b=None, exact=False, factors=None,
                            mixed=None):
    """:func:`draw_b_joint_structured_core` with its normals drawn from
    ``gen``."""
    z = _normal(gen, x.shape[:-1] + (_joint_dim(cm),), cm.cdtype, cm.device)
    return draw_b_joint_structured_core(cm, x, z, b, exact=exact,
                                        factors=factors, mixed=mixed)


# ===========================================================================
# the alternative correlated-ORF b-draws (``PTGIBBS_HD_KERNEL``)
# ===========================================================================
#
# Two Gibbs sweeps over the same joint conditional as the structured
# draw, kept for arrays of many pulsars: each step is an exact
# conditional, so the sweep leaves the joint law invariant but mixes the
# cross-pulsar correlations over sweeps.  Each carries ``b`` in (pad
# pulsars keep theirs bitwise), takes its update order as a per-chain
# permutation tensor, and factors in float64 (``blocked_chol_inv``) when
# ``exact`` and two-float (``tf_chol_factor``) otherwise.  A step whose
# draw is not finite leaves its coefficients as they were.  Returns
# ``(b', ok)``, ``ok`` (...,) the chains none of whose updates was
# skipped.

def _hd_setup(cm, x):
    """``(TNT, d, pinv, rho, Ginv)`` of the alternative draws: the
    segmented Gram (float32 segments, float64 reduce; kernel-ECORR
    models the widening Gram under their correction), 1/phi (..., P, B),
    rho (..., K) and the inverse ORF stack."""
    N = cm.ndiag_fast(x)
    TNT, d = tnt_d_x(cm, x, N) if cm.has_ke else tnt_d_seg(cm, N)
    pinv = 1.0 / cm.phi(x)
    rho = torch.pow(10.0, 2.0 * x.to(cm.cdtype)[..., cm.rho_ix_x])
    return TNT, d, pinv, rho, cm.orf_ginv_k(x)


def _rows_at(a, p, dim):
    """``a`` indexed at the per-chain position ``p`` (...,) along
    ``dim`` (counted from the end), ``a``'s leading dims the chains'."""
    nd = a.dim()
    dim = nd + dim if dim < 0 else dim
    idx = p.reshape(p.shape + (1,) * (nd - p.dim()))
    shape = list(a.shape)
    shape[dim] = 1
    return torch.gather(a, dim, idx.expand(shape)).squeeze(dim)


def _set_rows_at(a, p, dim, vals):
    """``a`` with its slice at ``p`` (...,) along ``dim`` set to
    ``vals``."""
    nd = a.dim()
    dim = nd + dim if dim < 0 else dim
    idx = p.reshape(p.shape + (1,) * (nd - p.dim()))
    shape = list(a.shape)
    shape[dim] = 1
    return a.scatter(dim, idx.expand(shape), vals.unsqueeze(dim))


def draw_b_hd_sequential_core(cm, x, b, z, perm, exact=False):
    """The pulsar-wise Gibbs sweep (``jax_backend.py::
    draw_b_hd_sequential``): pulsar ``p``'s coefficients given the
    others' are its own system with the common prior precision
    ``(G^-1)_pp / rho_k`` on its common columns and the mean shifted by
    ``-sum_{q != p} (G^-1)_pq a_q / rho_k``.  Every pulsar's precision
    depends on ``x`` alone, so the P factors are one batch before the
    sweep, and each step is ``base_p - Corr_p cross_p`` with the (Bmax,
    2K) slice ``Corr_p`` of the conditional covariance.  ``z`` (..., P,
    Bmax) float64 normals; ``perm`` (..., P) the pulsar order per
    chain."""
    cdt = cm.cdtype
    B, P, K = cm.Bmax, cm.P, cm.K
    lead = x.shape[:-1]
    TNT, d, pinv, rho, Ginv = _hd_setup(cm, x)
    Ginv = Ginv.expand(lead + (K, P, P))
    live = cm.psr_mask.to(cdt)
    gsin, gcos = cm.gw_sin_ix, cm.gw_cos_ix
    # the common columns carry the conditional prior precision
    prior_prec = (torch.diagonal(Ginv, dim1=-2, dim2=-1).transpose(-1, -2)
                  / rho[..., None, :])                          # (..., P, K)
    pin = _scatter_drop(_scatter_drop(pinv, gsin, prior_prec), gcos,
                        prior_prec)
    Sigma = TNT + pin[..., :, None] * torch.eye(B, dtype=cdt,
                                                 device=cm.device)
    dj = 1.0 / torch.sqrt(torch.diagonal(Sigma, dim1=-2, dim2=-1))
    A = Sigma * dj[..., :, None] * dj[..., None, :]
    _, Li = blocked_chol_inv(A) if exact else tf_chol_factor(A)
    base = dj * _mv(_t(Li), _mv(Li, dj * d) + z)
    _, valid, ccl = cm.gw_cols_valid()
    djc = _gather_last(dj, ccl) * valid                         # (..., P, 2K)
    Lic = torch.gather(Li, -1, ccl[:, None, :].expand(
        Li.shape[:-1] + ccl.shape[-1:])) * djc[..., None, :]   # (..., P, B, 2K)
    LiT = _t(Li)
    Corr = dj[..., :, None] * (_mm(LiT, Lic) if exact else tf_mm(LiT, Lic))
    a = torch.stack([_gather_last(b, gsin), _gather_last(b, gcos)],
                    dim=-1) * live[:, None, None]               # (..., P, K, 2)
    gcl = torch.clamp(torch.stack([gsin, gcos], -1), max=B - 1)  # (P, K, 2)
    ok_all = torch.ones(lead, dtype=torch.bool, device=cm.device)
    for s in range(P):
        p = perm[..., s]
        g_row = _rows_at(Ginv, p, -2)                           # (..., K, P)
        gpp = _rows_at(g_row, p, -1)                            # (..., K)
        a_p = _rows_at(a, p, -3)                                # (..., K, 2)
        cross = (torch.einsum("...kq,...qkf->...kf", g_row, a)
                 - gpp[..., :, None] * a_p) / rho[..., :, None]
        cvec = torch.cat([cross[..., 0], cross[..., 1]], dim=-1)
        bp = _rows_at(base, p, -2) - _mv(_rows_at(Corr, p, -3), cvec)
        ok = torch.isfinite(bp).all(-1)
        live_p = live[p] > 0
        ok_all = ok_all & (ok | ~live_p)
        bnew = torch.where((live_p & ok)[..., None], bp, _rows_at(b, p, -2))
        b = _set_rows_at(b, p, -2, bnew)
        cols_p = gcl[p]                                         # (..., K, 2)
        a_new = torch.gather(bnew, -1, cols_p.reshape(lead + (2 * K,)))
        a = _set_rows_at(a, p, -3, a_new.reshape(lead + (K, 2))
                         * live[p][..., None, None])
    return b, ok_all


def draw_b_hd_sequential(cm, x, gen, b, exact=False):
    """:func:`draw_b_hd_sequential_core` with its normals and its pulsar
    order (the argsort of uniform keys: no host sync, capture-safe)
    drawn from ``gen``."""
    lead = x.shape[:-1]
    z = _normal(gen, lead + (cm.P, cm.Bmax), cm.cdtype, cm.device)
    keys = torch.rand(lead + (cm.P,), generator=gen, dtype=torch.float64,
                      device=cm.device)
    return draw_b_hd_sequential_core(cm, x, b, z, torch.argsort(keys, -1),
                                     exact)


def _freq_groups(cm):
    """Coordinate groups per pulsar of the frequency-block sweep's joint
    step: common sin and cos, and intrinsic red sin and cos at the same
    frequency index where the red noise has columns of its own (the two
    are near-collinear; a block split between them mixes badly)."""
    Kr = int(cm.red_sin_ix.shape[1])
    return 4 if (Kr > 0 and not cm.red_shares_gw) else 2


def draw_b_hd_freqblock_core(cm, x, b, z1, z2, perm, exact=False):
    """The two-block frequency sweep (``jax_backend.py::
    draw_b_hd_freqblock``): (1) every pulsar's non-common coefficients
    given the common ones, one batched draw of the full system with the
    common rows turned into identity; (2) frequency by frequency, in the
    per-chain order ``perm`` (..., K), the joint draw across pulsars of
    that frequency's common sin/cos (and red sin/cos, see
    :func:`_freq_groups`) given every other coefficient: an (m P, m P)
    system whose common diagonal blocks carry ``G_k^-1 / rho_k``.
    ``z1`` (..., P, Bmax) and ``z2`` (..., K, m P) float64 normals."""
    factor = blocked_chol_inv if exact else tf_chol_factor
    cdt = cm.cdtype
    B, P, K = cm.Bmax, cm.P, cm.K
    lead = x.shape[:-1]
    dev = cm.device
    TNT, d, pinv, rho, Ginv = _hd_setup(cm, x)
    Ginv = Ginv.expand(lead + (K, P, P))
    _, valid, ccl = cm.gw_cols_valid()
    gwm = torch.zeros((P, B), dtype=cdt, device=dev).scatter_reduce(
        1, ccl, valid, reduce="amax")
    nm = 1.0 - gwm
    eyeB = torch.eye(B, dtype=cdt, device=dev)

    # ---- block 1: non-common | common ------------------------------------
    Sigma = TNT + (pinv * nm)[..., :, None] * eyeB
    Sn = Sigma * nm[:, :, None] * nm[:, None, :] + gwm[:, :, None] * eyeB
    rhs = nm * (d - _mv(TNT, b * gwm))
    dj = 1.0 / torch.sqrt(torch.diagonal(Sn, dim1=-2, dim2=-1))
    A = Sn * dj[..., :, None] * dj[..., None, :]
    _, Li = factor(A)
    bn = dj * _mv(_t(Li), _mv(Li, dj * rhs) + z1)
    # pad pulsars keep their b: their decoupled identity system draws
    # noise
    live = (cm.psr_mask > 0)[:, None]
    ok1 = torch.isfinite(bn).all(-1, keepdim=True)
    b = torch.where((gwm > 0) | ~ok1 | ~live, b, bn)
    ok_all = (ok1 | ~live).all(-1).all(-1)

    # ---- block 2: per-frequency joint draws across pulsars ---------------
    m = _freq_groups(cm)
    Kr = int(cm.red_sin_ix.shape[1])
    eyeP = torch.eye(P, dtype=cdt, device=dev)
    gsin = cm.gw_sin_ix.expand(lead + (P, K))
    gcos = cm.gw_cos_ix.expand(lead + (P, K))
    rsin = cm.red_sin_ix.expand(lead + (P, Kr))
    rcos = cm.red_cos_ix.expand(lead + (P, Kr))
    livep = cm.psr_mask > 0
    for s in range(K):
        k = perm[..., s]
        kP = k[..., None].expand(lead + (P,))
        gcols = [_rows_at(gsin, kP, -1), _rows_at(gcos, kP, -1)]
        vals = [((c >= 0) & (c < B)).to(cdt) for c in gcols]
        if m == 4:
            kr = torch.clamp(kP, max=Kr - 1)
            in_r = (kP < Kr).to(cdt)
            for rarr in (rsin, rcos):
                c = _rows_at(rarr, kr, -1)
                gcols.append(c)
                vals.append(((c >= 0) & (c < B)).to(cdt) * in_r)
        c4 = torch.clamp(torch.stack(gcols, -1), 0, B - 1)      # (..., P, m)
        v4 = torch.stack(vals, -1)
        Tr = torch.gather(TNT, -2, c4[..., None].expand(
            lead + (P, m, B))) * v4[..., None]                  # (..., P, m, B)
        T4 = torch.gather(Tr, -1, c4[..., None, :].expand(
            lead + (P, m, m))) * v4[..., None, :]               # (..., P, m, m)
        Dg = _rows_at(Ginv, k, -3) / _rows_at(rho, k, -1)[..., None, None]
        rows = []
        for i in range(m):
            row = []
            for j in range(m):
                blk = torch.diag_embed(T4[..., i, j])
                if i == j:
                    vi = v4[..., i]
                    if i < 2:
                        blk = (blk + Dg * vi[..., :, None] * vi[..., None, :]
                               + (1.0 - vi)[..., None, :] * eyeP)
                    else:
                        pri = torch.gather(pinv, -1, c4[..., i:i + 1])[..., 0]
                        blk = blk + torch.diag_embed(
                            torch.where(vi > 0, pri, 1.0))
                row.append(blk)
            rows.append(torch.cat(row, dim=-1))
        Q = torch.cat(rows, dim=-2)                             # (..., mP, mP)
        a4 = torch.gather(b, -1, c4) * v4
        r = (torch.gather(d, -1, c4) * v4 - _mv(Tr, b) + _mv(T4, a4))
        r = r.transpose(-1, -2).reshape(lead + (m * P,))        # group-major
        qj = 1.0 / torch.sqrt(torch.diagonal(Q, dim1=-2, dim2=-1))
        _, Lq = factor(Q * qj[..., :, None] * qj[..., None, :])
        zk = _rows_at(z2, k, -2)
        anew = (qj * _mv(_t(Lq), _mv(Lq, qj * r) + zk)).reshape(
            lead + (m, P))
        okk = torch.isfinite(anew).all(-1).all(-1)
        ok_all = ok_all & okk
        for i in range(m):
            ci = c4[..., i]
            old = torch.gather(b, -1, ci[..., None])[..., 0]
            new = torch.where((v4[..., i] > 0) & okk[..., None] & livep,
                              anew[..., i, :], old)
            b = b.scatter(-1, ci[..., None], new[..., None])
    return b, ok_all


def draw_b_hd_freqblock(cm, x, gen, b, exact=False):
    """:func:`draw_b_hd_freqblock_core` with its normals and its
    frequency order (argsort of uniform keys) drawn from ``gen``."""
    lead = x.shape[:-1]
    m = _freq_groups(cm)
    z1 = _normal(gen, lead + (cm.P, cm.Bmax), cm.cdtype, cm.device)
    z2 = _normal(gen, lead + (cm.K, m * cm.P), cm.cdtype, cm.device)
    keys = torch.rand(lead + (cm.K,), generator=gen, dtype=torch.float64,
                      device=cm.device)
    return draw_b_hd_freqblock_core(cm, x, b, z1, z2,
                                    torch.argsort(keys, -1), exact)


# ===========================================================================
# white-noise block
# ===========================================================================

def lnlike_white_per(cm, x, r2):
    """Per-pulsar white-noise log-likelihood given b, (..., P), in the
    sigma^2-scaled form ``N = sigma^2 M`` (every intermediate of value,
    gradient and Hessian O(1)-O(1e4))."""
    cdt = cm.cdtype
    xev = cm.xe(x)
    efac = cm.gx(xev, cm.efac_ix)
    equad = cm.gx(xev, cm.equad_ix)
    gequad = cm.gx(xev, cm.gequad_ix)
    s2 = cm.sigma2.to(cdt)
    ln_s2 = torch.log(s2)
    ln10_2 = 2.0 * _LN10
    M = (efac * efac + torch.exp(ln10_2 * equad - ln_s2)
         + torch.exp(ln10_2 * gequad - ln_s2))
    w = r2.to(cdt) / s2
    return -0.5 * (cm.toa_mask * (ln_s2 + torch.log(M) + w / M)).sum(-1)


def white_ll_rel(cm, x0, r2):
    """Closure ``q -> ll(q) - ll(x0)`` per pulsar in the storage dtype,
    with the cancellation done per TOA before the sum (``z = N0/Nq``,
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
    """The white MH block's target: the diagonal relative form, or its
    Woodbury form when the model compiles kernel ECORR."""
    if cm.has_ke:
        return white_ll_ke(cm, x, r, r2)
    return white_ll_rel(cm, x, r2)


def white_ll_ke(cm, x0, r, r2):
    """Kernel-ECORR white-block closure: the storage-dtype relative
    diagonal form plus the Woodbury correction at ``q`` (its ``x0``
    constant cancels in MH differences), ``r`` the block-fixed residual.  N is
    ``ndiag_fast`` throughout, as in the exact b-draw's weights."""
    base = white_ll_rel(cm, x0, r2)

    def ll(q):
        Nq = cm.ndiag_fast(q)
        return base(q) + ke_ll_corr(cm, q, Nq, ke_rz(cm, Nq, r))

    return ll


def ecorr_ll_ke(cm, x0, r):
    """Kernel-ECORR block closure (the ECORR amplitudes alone move): with
    D fixed at ``x0``, ``s_e`` and ``z_e^2`` are formed once and each
    step costs O(Emax) per pulsar.  Differentiable: the same closure is
    the Laplace proposal's curvature target."""
    cdt = cm.cdtype
    invN = cm.toa_mask.to(cdt) / cm.ndiag_fast(x0).to(cdt)
    s = ke_segsum(cm, invN)
    z = ke_segsum(cm, r.to(cdt) * invN)
    z2 = z * z

    def ll(q):
        c = torch.pow(10.0, 2.0 * cm.xe(q)[..., cm.ke_par_ix])
        w = c / (1.0 + c * s)
        return -0.5 * (torch.log1p(c * s).sum(-1) - (w * z2).sum(-1))

    return ll


def _ecorr_coeffs(cm, b):
    """``(b at the ECORR columns, live mask)``, each (..., P, We)."""
    B = cm.Bmax
    bj = torch.gather(b, -1, torch.clamp(cm.ec_cols, max=B - 1).expand(
        b.shape[:-1] + cm.ec_cols.shape[-1:]))
    return bj, cm.ec_cols < B


def lnlike_ecorr_per(cm, x, b):
    """Per-pulsar ECORR conditional log-likelihood (..., P) in the compute
    dtype: the coefficients on the ECORR columns are independent
    ``N(0, 10^(2 e))``, ``e`` the owning backend's log10_ecorr.  The
    Laplace curvature's target."""
    cdt = cm.cdtype
    bj, live = _ecorr_coeffs(cm, b)
    mask = live.to(cdt)
    bj = bj.to(cdt)
    e = cm.xe(x)[..., cm.ec_ix]
    return (mask * (-_LN10 * e - 0.5 * bj * bj * torch.pow(10.0, -2.0 * e))
            ).sum(-1)


def ecorr_ll_rel(cm, x0, b):
    """Closure ``q -> ll(q) - ll(x0)`` of the ECORR conditional per
    pulsar in the storage dtype: ``-ln10 (e_q - e_0) + 0.5 u (1 -
    10^(2 (e_0 - e_q)))`` per column with ``u = b^2 / 10^(2 e_0)``."""
    fdt = cm.dtype
    xev0 = cm.xe(x0)
    e0c = xev0[..., cm.ec_ix]
    e0 = e0c.to(fdt)
    bj, live = _ecorr_coeffs(cm, b)
    mask = live.to(fdt)
    u = (bj * bj * torch.pow(10.0, -2.0 * e0c)).to(fdt)

    def ll_rel(q):
        eq = cm.xe(q).to(fdt)[..., cm.ec_ix]
        ratio = torch.pow(10.0, 2.0 * (e0 - eq))
        return (mask * (-_LN10 * (eq - e0) + 0.5 * u * (1.0 - ratio))
                ).sum(-1)

    return ll_rel


def ecorr_block_ll(cm, x, b, r):
    """The ECORR MH block's target: the basis coefficients' conditional
    (``r`` unused), or the kernel-ECORR conditional on the residual
    ``r = y - T b``."""
    if cm.has_ke:
        return ecorr_ll_ke(cm, x, r)
    return ecorr_ll_rel(cm, x, b)


def _mh_step(cm, lnlike, ind, accepts=None):
    """One single-site Metropolis step with the scale-mixture proposal,
    jump sd tied to the coordinate's prior width; returns
    ``step(carry, noise)`` with ``noise = (scale, jpos, eps, logu)``
    (jpos indexes ``ind``, host indices or a device tensor: under a CUDA
    graph's capture, the latter).  ``accepts`` (...,) float64, when
    given, gains each chain's accepted steps in place."""
    if not torch.is_tensor(ind):
        ind = torch.as_tensor(np.asarray(ind), dtype=torch.int64,
                              device=cm.device)
    prop = cm.prop_scale.to(cm.cdtype)

    def step(carry, noise):
        x, ll0, lp0 = carry
        scale, jpos, eps, logu = noise
        j = ind[jpos]
        # a tenant stack's scales (T, nx): each row's own
        pj = prop[j] if prop.dim() == 1 else prop.gather(-1, j[..., None])[
            ..., 0]
        q = x.scatter_add(-1, j[..., None],
                          (eps * pj * scale)[..., None])
        lp1 = cm.lnprior(q)
        ll1 = lnlike(q)
        ok = torch.isfinite(lp1) & torch.isfinite(ll1)
        logr = torch.where(ok, (ll1 + lp1) - (ll0 + lp0),
                           torch.full_like(ll1, -math.inf))
        acc = logr > logu
        x = torch.where(acc[..., None], q, x)
        ll0 = torch.where(acc, ll1, ll0)
        lp0 = torch.where(acc, lp1, lp0)
        if accepts is not None:
            accepts.add_(acc.to(accepts.dtype))
        return (x, ll0, lp0), x[..., ind]

    return step


def mh_scan_core(cm, x, lnlike, ind, scale, jpos, eps, logu, accepts=None):
    """Fixed-length single-site MH sub-chain over coordinates ``ind``;
    the noise arrays lead with the step axis.  Returns ``(x', rec)``,
    ``rec`` (steps, ..., len(ind)); ``accepts`` (...,), when given,
    gains each chain's accepted steps in place."""
    step = _mh_step(cm, lnlike, ind, accepts)
    carry = (x, lnlike(x), cm.lnprior(x))
    rec = []
    for s in range(scale.shape[0]):
        carry, r = step(carry, (scale[s], jpos[s], eps[s], logu[s]))
        rec.append(r)
    return carry[0], torch.stack(rec)


def mh_scan(cm, x, gen, lnlike, ind, nsteps, accepts=None):
    """:func:`mh_scan_core` with its noise drawn from ``gen``."""
    cdt, dev = cm.cdtype, cm.device
    shape = (nsteps,) + x.shape[:-1]

    def noise(fn):
        return _draw(cm, fn, shape, 1)

    scale = noise(lambda s: _scale_choice(gen, s, cdt, dev))
    jpos = noise(lambda s: torch.randint(0, len(ind), s, generator=gen,
                                         device=dev))
    eps = noise(lambda s: _normal(gen, s, cdt, dev))
    logu = torch.log(noise(lambda s: _uniform(gen, s, cdt, dev)))
    return mh_scan_core(cm, x, lnlike, ind, scale, jpos, eps, logu,
                        accepts)


def lnlike_orf_fn(cm, b):
    """The b-conditional likelihood of sampled ORF weights: per
    (frequency, phase) group the common coefficients are jointly ``N(0,
    rho_k G(theta))``, so up to theta-free constants

        ln L(theta) = -K ln det G - 1/2 sum_{k, phase} a_k^T G^-1 a_k / rho_k

    (two phases: K, not K/2, log-determinants).  Returns ``q ->`` (...,)
    for states ``q`` (..., nx).  G is factored by ``cholesky_ex``, as the
    JAX function factors it by the library's Cholesky; a
    non-positive-definite G (a nonzero ``info``, whose partial factor is
    finite) makes the log-likelihood NaN without the host reading
    ``info``, so the MH step's finite guard rejects such a proposal and a
    chain never leaves the positive-definite region it starts in."""
    cdt = cm.cdtype
    live = cm.psr_mask.to(cdt)
    A = torch.stack([_gather_last(b, cm.gw_sin_ix),
                     _gather_last(b, cm.gw_cos_ix)], dim=-1) \
        * live[:, None, None]                                   # (..., P, K, 2)
    A = A.reshape(A.shape[:-2] + (-1,))                          # (..., P, 2K)

    def lnlike(q):
        L, info = torch.linalg.cholesky_ex(cm.orf_G(q))
        logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        logdet = torch.where(info == 0, logdet, math.nan)
        rho = torch.pow(10.0, 2.0 * q.to(cdt)[..., cm.rho_ix_x])   # (..., K)
        w = torch.linalg.solve_triangular(
            L, A.expand(L.shape[:-2] + A.shape[-2:]), upper=False)
        w = w.reshape(w.shape[:-1] + (cm.K, 2))
        quad = (w * w / rho[..., None, :, None]).sum((-3, -2, -1))
        return -cm.K * logdet - 0.5 * quad

    return lnlike


def parallel_cov_mh_scan_core(cm, x, ll_per_fn, par_ix, nper, chol,
                              scale, z, logu, coin=None, record=True,
                              mode=None, asqrt=None, inflate=1.3):
    """Per-pulsar full-block MH with adapted proposals (storage dtype),
    mixing a random walk ``x_p + scale (2.38/sqrt(W_p)) L_p z`` with,
    when ``mode`` is given, an independence proposal ``mode_p + inflate
    L_p z`` accepted with its Hastings ratio.

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
    pa = len(shape) - 1

    def noise(fn, shp=shape):
        return _draw(cm, fn, shp, 1, pa)

    scale = noise(lambda s: _scale_choice(gen, s, fdt, dev))
    z = noise(lambda s: _normal(gen, s, fdt, dev), shape + (W,))
    logu = torch.log(noise(lambda s: _uniform(gen, s, fdt, dev)))
    coin = None
    if mode is not None:
        coin = noise(lambda s: _uniform(gen, s, fdt, dev)) < p_indep
    return parallel_cov_mh_scan_core(
        cm, x, ll_per_fn, par_ix, nper, chol, scale, z, logu, coin=coin,
        record=record, mode=mode, asqrt=asqrt, inflate=inflate)


def _prior_halfwidth2(cm):
    """(nx,) squared prior half-widths (normal: 2 sd), in the storage
    dtype of ``pa``/``pb`` as the JAX package's numpy computes them."""
    pb, pa = cm.pb, cm.pa
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


def _rho_hd_logpdf(cm, x, b, grid):
    """The correlated-ORF rho conditional on the grid, (..., K, R):
    ``p(rho_k | a) ~ rho^-P exp(-taut_k / rho)`` with the quadratic form
    ``taut_k = 1/2 sum_phase a_k^T G_k^-1 a_k`` of the common
    coefficients ``a_k`` (P,) (``sum_p tau_pk`` at G = I)."""
    Ginv = cm.orf_ginv_k(x)
    # a fixed stack is shared by every chain; sampled weights give one
    # per chain
    eq = ("...pk,kpq,...qk->...k" if Ginv.dim() == 3
          else "...pk,...kpq,...qk->...k")
    live = cm.psr_mask.to(cm.cdtype)
    taut = 0.0
    for ix in (cm.gw_sin_ix, cm.gw_cos_ix):
        a = _gather_last(b, ix) * live[:, None]                # (..., P, K)
        taut = taut + 0.5 * torch.einsum(eq, a, Ginv, a)
    return (-cm.P_real * torch.log(grid)
            - (taut[..., None] / grid).to(cm.dtype))


def _rho_collapsed_applies(cm, enabled=None) -> bool:
    """The partially collapsed common-rho draw applies: the switch is on
    (``enabled``; None reads ``PTGIBBS_RHO_COLLAPSE``) and the model is a
    CRN whose sampled per-pulsar free-spectrum red shares the common
    Fourier columns (a constant red must keep the conditional draw:
    marginalizing a fixed amplitude over its prior would target another
    posterior).  The JAX package's predicate; it measured the draw as
    net-negative in ESS per second, so it is off by default."""
    if enabled is None:
        from ..config import rho_collapse_choice

        enabled = rho_collapse_choice()
    return bool(enabled and cm.orf_name == "crn"
                and cm.red_kind == "free_spectrum" and cm.red_shares_gw
                and bool((cm.red_rho_ix_x < cm.nx).any()))


def _rho_collapsed_logpdf(cm, ltau, grid):
    """The collapsed rho conditional on the grid, (..., K, R), from
    ``ltau`` (..., P, K): per pulsar and frequency, the red amplitude
    integrated out over its log-uniform prior by a ``RHO_COLLAPSE_J``-
    point quadrature, ``logsumexp_j (r_j - e^r_j) - ln J`` with ``r_j =
    log tau - log(rho + red_j)``; slots without a sampled red amplitude
    keep the plain factor; summed over real pulsars.  One frequency at a
    time, and within it grid chunks, so that no intermediate exceeds
    ``RHO_COLLAPSE_CHUNK_BYTES`` (the JAX package maps over K)."""
    fdt, dev = cm.dtype, cm.device
    J = RHO_COLLAPSE_J
    lgrid = torch.log(grid)
    redg = torch.pow(10.0, torch.linspace(
        math.log10(cm.red_rhomin), math.log10(cm.red_rhomax), J,
        dtype=fdt, device=dev))
    K = ltau.shape[-1]
    n = min(K, cm.red_rho_ix_x.shape[-1])
    ap = torch.zeros(cm.red_rho_ix_x.shape[:-1] + (K,), dtype=torch.bool,
                     device=dev)
    ap[..., :n] = (cm.red_rho_ix_x < cm.nx)[..., :n]
    pmask = cm.psr_mask[..., None] > 0
    lead = ltau.shape[:-1]                               # (..., P)
    per_point = math.prod(lead) * J * ltau.element_size()
    step = max(1, min(grid.shape[0],
                      RHO_COLLAPSE_CHUNK_BYTES // per_point))
    zero = torch.zeros((), dtype=fdt, device=dev)
    out = []
    for k in range(K):
        ltk = ltau[..., k]                               # (..., P)
        parts = []
        for r0 in range(0, grid.shape[0], step):
            lq = torch.log(grid[r0:r0 + step, None] + redg)   # (r, J)
            lr = ltk[..., None, None] - lq                # (..., P, r, J)
            parts.append(torch.logsumexp(lr - torch.exp(lr), dim=-1))
        lm = torch.cat(parts, dim=-1) - math.log(J)       # (..., P, R)
        lp = ltk[..., None] - lgrid
        lm = torch.where(ap[..., k, None], lm, lp - torch.exp(lp))
        out.append(torch.where(pmask, lm, zero).sum(-2))
    return torch.stack(out, dim=-2)


def rho_update_core(cm, x, b, gumbel, collapse=False):
    """Common free-spectrum log10_rho draw, Gumbel-max sampled on the
    log-uniform grid: per-pulsar log-PDF grids summed over the pulsar
    axis or, under a correlated ORF, the quadratic-form conditional of
    :func:`_rho_hd_logpdf`; with ``collapse`` (where
    :func:`_rho_collapsed_applies`) the partially collapsed conditional
    of :func:`_rho_collapsed_logpdf`, the red amplitudes integrated out
    (the sweep then draws red | rho at once: together an exact blocked
    draw of (rho, red) | b).  ``gumbel`` (..., K, R) in the storage
    dtype."""
    if cm.K == 0 or len(cm.rho_ix_x) == 0:
        return x
    if _rho_invcdf_applies(cm):
        raise ValueError("a single pulsar without intrinsic red noise "
                         "draws its rho by inverse CDF: rho_invcdf_core")
    fdt = cm.dtype
    grid = _rho_grid(cm, cm.rhomin, cm.rhomax)
    if cm.orf_name != "crn":
        rhonew = grid[torch.argmax(_rho_hd_logpdf(cm, x, b, grid) + gumbel,
                                   dim=-1)]
        x = x.clone()
        x[..., cm.rho_ix_x] = (0.5 * torch.log10(rhonew)).to(x.dtype)
        return x
    ltau = torch.log(cm.gw_tau(b)).to(fdt)
    if collapse:
        logpdf = _rho_collapsed_logpdf(cm, ltau, grid)
        rhonew = grid[torch.argmax(logpdf + gumbel, dim=-1)]
        x = x.clone()
        x[..., cm.rho_ix_x] = (0.5 * torch.log10(rhonew)).to(x.dtype)
        return x
    lother = torch.log(cm.red_phi(x)).to(fdt)
    live = cm.psr_mask[..., None, None]
    if cm.shard is not None:
        # a shard's per-pulsar terms, gathered: the grid and its sum over
        # pulsars are formed whole on every rank, in the logical order
        live = live[..., 0].to(fdt).expand(ltau.shape)
        ltau, lother, live = sharding.gather_pulsars(
            cm.shard, torch.stack([ltau, lother, live]), -2).unbind(0)
        live = live[..., None]
    logpdf = _grid_logpdf(ltau, lother, grid)
    # mask by where, not multiply: a pad pulsar's log tau is -inf
    logpdf = torch.where(live > 0, logpdf,
                         torch.zeros((), dtype=fdt, device=cm.device))
    logpdf = logpdf.sum(-3)
    rhonew = grid[torch.argmax(logpdf + gumbel, dim=-1)]
    x = x.clone()
    x[..., cm.rho_ix_x] = (0.5 * torch.log10(rhonew)).to(x.dtype)
    return x


def _rho_invcdf_applies(cm) -> bool:
    """One pulsar without intrinsic red noise under the CRN: its common
    rho has an exact truncated inverse-CDF draw."""
    return cm.P_real == 1 and cm.red_kind == "" and cm.orf_name == "crn"


def rho_invcdf_core(cm, x, b, u):
    """Single-pulsar common free-spectrum log10_rho draw, exact by the
    truncated inverse CDF of ``p(rho_k) ~ exp(-tau_k / rho_k) / rho_k``
    on ``[rhomin, rhomax]``, in the compute dtype; ``u`` (..., K) float64
    uniforms.  ``tau`` is clamped at ``rhomin * 1e-6``: at ``tau = 0`` the
    inverse CDF is 0/0, and the clamped draw has the ``tau -> 0`` limit
    with a relative density error ~1e-6."""
    if cm.K == 0 or len(cm.rho_ix_x) == 0:
        return x
    tau = sharding.gather_pulsars(cm.shard, cm.gw_tau(b), -2)
    t = torch.clamp(tau[..., 0, :], min=cm.rhomin * 1e-6)
    hi = -torch.expm1(t / cm.rhomax - t / cm.rhomin)
    eta = hi * u
    rhonew = t / (t / cm.rhomax - torch.log1p(-eta))
    x = x.clone()
    x[..., cm.rho_ix_x] = (0.5 * torch.log10(rhonew)).to(x.dtype)
    return x


def rho_update(cm, x, b, gen, collapse=False):
    """The common log10_rho draw with its noise drawn from ``gen``:
    :func:`rho_invcdf_core` (uniforms) for a single pulsar without
    intrinsic red noise, :func:`rho_update_core` (Gumbels; ``collapse``
    its collapsed form) otherwise."""
    if _rho_invcdf_applies(cm):
        u = _draw(cm, lambda s: torch.rand(s, generator=gen,
                                           dtype=cm.cdtype,
                                           device=cm.device),
                  x.shape[:-1] + (cm.K,), 0)
        return rho_invcdf_core(cm, x, b, u)
    shape = x.shape[:-1] + (cm.K, settings.rho_grid_size)
    return rho_update_core(
        cm, x, b, _draw(cm, lambda s: _gumbel(gen, s, cm.dtype, cm.device),
                        shape, 0), collapse=collapse)


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
    return red_conditional_update_core(cm, x, b, _draw(
        cm, lambda s: _gumbel(gen, s, cm.dtype, cm.device), shape, 0,
        x.dim() - 1))


def tprocess_alpha_update_core(cm, x, b, gumbel):
    """Per-frequency draw of the t-process scale factors: the shared
    Fourier columns carry ``phi = o + alpha plaw`` (``o`` the common
    process aligned to the red grid), so under the InvGamma(1, 1) prior

        p(alpha | b) ~ alpha^-2 e^(-1/alpha)
                       (o + alpha plaw)^-1 exp(-tau / (o + alpha plaw)),

    ``tau = (b_sin^2 + b_cos^2) / 2``, Gumbel-max sampled on the
    log-uniform grid of ``TP_ALPHA_GRID`` points over ``[10^
    TP_ALPHA_LOG10_MIN, 10^TP_ALPHA_LOG10_MAX]`` (the point mass carries
    the grid's Jacobian alpha); the log variance is formed in log space.
    As ``o -> 0`` it is the conjugate InvGamma(2, 1 + tau / plaw) draw.
    ``gumbel`` (..., P, Kr, TP_ALPHA_GRID) in the storage dtype; the
    first maximum wins."""
    from .compiled import _lnphi_powerlaw

    cdt = cm.cdtype
    xev = cm.xe(x)
    tau = cm.red_tau(b).to(cdt)
    args = [xev[..., cm.red_hyp_ix[:, h]][..., None] for h in range(2)]
    lnplaw = _lnphi_powerlaw(cm.red_f, cm.red_df, *args)
    other = cm.gw_phi_at_red(x)
    grid = torch.pow(10.0, torch.linspace(
        TP_ALPHA_LOG10_MIN, TP_ALPHA_LOG10_MAX, TP_ALPHA_GRID, dtype=cdt,
        device=cm.device))
    lg = torch.log(grid)
    lnvar = torch.logaddexp(torch.log(other)[..., None],
                            lnplaw[..., None] + lg)
    logpdf = (-lg - 1.0 / grid - lnvar
              - tau[..., None] * torch.exp(-lnvar)).to(cm.dtype)
    alpha = grid[torch.argmax(logpdf + gumbel, dim=-1)]
    return _set_x(x, cm.red_rho_ix_x, alpha)


def tprocess_alpha_update(cm, x, b, gen):
    """:func:`tprocess_alpha_update_core` with its Gumbels from
    ``gen``."""
    shape = x.shape[:-1] + tuple(cm.red_rho_ix_x.shape) + (TP_ALPHA_GRID,)
    return tprocess_alpha_update_core(cm, x, b, _draw(
        cm, lambda s: _gumbel(gen, s, cm.dtype, cm.device), shape, 0,
        x.dim() - 1))


def _rho_scale_applies(cm) -> bool:
    """CRN free-spectrum common block with a sampled rho and diagonal N
    (the moves' residual update assumes it: not under kernel ECORR)."""
    return (cm.orf_name == "crn" and cm.gw_kind == "free_spectrum"
            and bool(cm.K) and len(cm.rho_ix_x) > 0 and not cm.has_ke)


def rho_scale_moves_core(cm, x, b, u, eps, logu, beta=None):
    """Interweaving scale moves along the rho <-> b funnel: per frequency
    k, jointly propose ``rho_k -> e^z rho_k`` and ``b_pk -> e^(z/2) b_pk``
    on the shared columns (``z = RHO_SCALE_SIGMA * eps[..., k]``),
    Metropolis-accepted with the exact joint density ratio and the
    Jacobian ``e^(z n/2)``.  ``eps``/``logu`` (..., K) float64; ``beta``
    (...,) scales the likelihood delta only (prior and Jacobian
    untempered).  Returns ``(x, b, u)`` with ``u = T b`` updated in place
    of a new matvec."""
    cdt, fdt = cm.cdtype, cm.dtype
    B, P, K = cm.Bmax, cm.pn, cm.K
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
        # per-pulsar sums over the TOAs, then over pulsars in the compute
        # dtype (below), in the logical order on a shard
        rt = (r * t * invN).sum(-1).to(cdt)
        tt = (t * t * invN).sum(-1).to(cdt)
        # a (1,) index: indexing with a 0-d device tensor reads it on the
        # host, a sync a captured CUDA graph cannot hold
        rix = cm.rho_ix_x[k:k + 1]
        xr = x.index_select(-1, rix)[..., 0]
        lrho = 2.0 * _LN10 * xr.to(cdt)
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
            torch.zeros((), dtype=cdt, device=cm.device))
        if cm.shard is None:
            rt, tt, dlp, nvs = rt.sum(-1), tt.sum(-1), dlp.sum(-1), nv.sum()
        else:
            rt, tt, dlp, nvs = sharding.gather_pulsars(
                cm.shard, torch.stack([rt, tt, dlp, nv.expand(dlp.shape)]),
                -1).sum(-1).unbind(0)
        d64 = delta.to(cdt)
        dll = d64 * rt - 0.5 * d64 * d64 * tt
        if beta is not None:
            dll = dll * beta.to(dll.dtype)
        njac = 0.5 * nvs * z
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
        x.index_copy_(-1, rix, torch.where(acc, xr + step, xr)[..., None])
    return x, b, u


def rho_scale_moves(cm, x, b, u, gen, beta=None):
    """:func:`rho_scale_moves_core` with its noise drawn from ``gen``."""
    shape = x.shape[:-1] + (cm.K,)
    eps = _draw(cm, lambda s: _normal(gen, s, cm.cdtype, cm.device),
                shape, 0)
    logu = torch.log(_draw(cm, lambda s: _uniform(gen, s, cm.cdtype,
                                                  cm.device), shape, 0))
    return rho_scale_moves_core(cm, x, b, u, eps, logu, beta)


# ===========================================================================
# powerlaw hyper block
# ===========================================================================

def lnlike_hyper_fn(cm, x, b, phi_fn=None):
    """b-conditional log-likelihood of the GP hyperparameters (..., ):
    ``-0.5 sum over the Fourier-GP columns of (log phi + b^2 / phi)``.
    ``phi_fn`` (from ``cm.phi_hyper_split``) evaluates only the
    hyper-dependent components."""
    phi = cm.phi(x) if phi_fn is None else phi_fn(x)
    b2 = (b * b).to(cm.cdtype)
    return -0.5 * (cm.gp_mask.to(cm.cdtype)
                   * (torch.log(phi) + b2 / phi)).sum((-2, -1))


def lnlike_fullmarg_fn(cm, x, TNT, d):
    """b-marginalized log-likelihood (..., ) given the Gram ``(TNT, d)``
    of the state's white noise (float64): the factor chain of
    ``kernels.chol_solve_sample`` at float64 (a CUDA kernel on a card)
    gives ``L``, ``dj`` and the mean ``Sigma^-1 d``, and ``log det Sigma =
    2 sum log L_ii - 2 sum log dj``."""
    N = cm.ndiag(x)
    phi = cm.phi(x)
    out = -0.5 * (cm.toa_mask * (torch.log(N) + cm.y ** 2 / N)).sum((-2, -1))
    if cm.has_ke:
        # the block N's log det and y^T N^-1 y (TNT, d from tnt_d_x)
        out = out + ke_ll_corr(cm, x, N, ke_rz(cm, N, cm.y)).sum(-1)
    logdet_phi = torch.log(phi).sum(-1)
    Sigma = TNT + _batched_diag(1.0 / phi)
    L, _, dj, mean, _ = _factor_batch(Sigma, d, torch.zeros_like(d))
    logdet_sigma = (2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1))
                    .sum(-1) - 2.0 * torch.log(dj).sum(-1))
    return out + 0.5 * ((d * mean).sum(-1) - logdet_sigma
                        - logdet_phi).sum(-1)


class RedNoise(NamedTuple):
    """The noise of :func:`red_mh_block_core`, each (steps, ...): the
    branch uniform ``r``; the SCAM eigendirection ``j`` and normal
    ``eps_scam``; the AM normals ``z_am`` (steps, ..., d); the single-site
    scale ``scale``, position ``jj`` (into the block) and normal
    ``eps_ss``; the DE history rows ``a_ix``, ``b_ix`` and the gamma
    uniform ``g`` (None without a history); the accept log-uniform
    ``logu``."""

    r: torch.Tensor
    j: torch.Tensor
    eps_scam: torch.Tensor
    z_am: torch.Tensor
    scale: torch.Tensor
    jj: torch.Tensor
    eps_ss: torch.Tensor
    a_ix: torch.Tensor
    b_ix: torch.Tensor
    g: torch.Tensor
    logu: torch.Tensor


def _rows(a, ix):
    """``a[..., ix, :]`` for a per-batch index ``ix`` (...,)."""
    return torch.gather(a, -2, ix[..., None, None].expand(
        ix.shape + (1, a.shape[-1])))[..., 0, :]


def red_mh_block_core(cm, x, b, U, S, noise, hist=None, accepts=None):
    """The powerlaw hyper block: Metropolis steps on the b-conditional
    likelihood of every ``log10_A``/``gamma`` (``cm.idx.red``), each step
    one of four symmetric proposals by the branch uniform: with a DE
    history ``hist`` (..., H, d), differential evolution ``gamma (h_a -
    h_b)`` (r < .5; gamma = 1 on 10% of jumps), a jump along one adapted
    covariance eigendirection (SCAM, < .65), a full adapted-covariance
    jump (AM, < .8) or a single-site scale-mixture jump; without one,
    SCAM (< .25), AM (< .5), single-site.  ``U``/``S`` (..., d, d) /
    (..., d): the SVD of the adapted covariance; ``noise`` a
    :class:`RedNoise`.  ``accepts`` (..., ), when given, gains each
    chain's accepted steps in place.  Returns ``x'``."""
    cdt = cm.cdtype
    rind = cm.red_ix
    d = int(rind.numel())
    sigma = 0.05 * d
    _, phi_dyn = cm.phi_hyper_split(x)

    def lnlike(q):
        return lnlike_hyper_fn(cm, q, b, phi_fn=phi_dyn)

    gamma0 = 2.38 / math.sqrt(2.0 * d)
    am_scale = 2.38 / math.sqrt(d)
    am_sqrt = U * torch.sqrt(S)[..., None, :]
    pos = torch.arange(d, device=cm.device)
    ll0, lp0 = lnlike(x), cm.lnprior(x)
    ninf = torch.full_like(ll0, -math.inf)
    for s in range(noise.r.shape[0]):
        j = noise.j[s]
        Sj = torch.gather(S, -1, j[..., None])[..., 0]
        Uj = torch.gather(U, -1, j[..., None, None].expand(
            j.shape + (d, 1)))[..., 0]
        d_scam = (2.38 * torch.sqrt(Sj) * noise.eps_scam[s])[..., None] * Uj
        d_am = am_scale * torch.matmul(am_sqrt, noise.z_am[s][..., None])[
            ..., 0]
        v_ss = noise.eps_ss[s] * sigma * noise.scale[s]
        d_ss = torch.where(pos == noise.jj[s][..., None], v_ss[..., None],
                           torch.zeros((), dtype=cdt, device=cm.device))
        r = noise.r[s][..., None]
        if hist is not None:
            g = noise.g[s]
            gamma = torch.where(g < 0.1, torch.ones_like(g),
                                torch.full_like(g, gamma0))
            d_de = gamma[..., None] * (_rows(hist, noise.a_ix[s])
                                       - _rows(hist, noise.b_ix[s]))
            delta = torch.where(r < 0.5, d_de, torch.where(
                r < 0.65, d_scam, torch.where(r < 0.8, d_am, d_ss)))
        else:
            delta = torch.where(r < 0.25, d_scam,
                                torch.where(r < 0.5, d_am, d_ss))
        q = _add_x(x, rind, delta)
        lp1 = cm.lnprior(q)
        ll1 = lnlike(q)
        ok = torch.isfinite(lp1) & torch.isfinite(ll1)
        logr = torch.where(ok, (ll1 + lp1) - (ll0 + lp0), ninf)
        acc = logr > noise.logu[s]
        x = torch.where(acc[..., None], q, x)
        ll0 = torch.where(acc, ll1, ll0)
        lp0 = torch.where(acc, lp1, lp0)
        if accepts is not None:
            accepts += acc
    return x


def red_noise(cm, gen, lead, nsteps, H=None):
    """A :class:`RedNoise` of ``nsteps`` steps for chains ``lead`` drawn
    from ``gen`` (the DE entries only with a history of ``H`` rows)."""
    cdt, dev = cm.cdtype, cm.device
    d = len(cm.idx.red)
    shape = (nsteps,) + tuple(lead)

    def uni():
        return torch.rand(shape, generator=gen, dtype=cdt, device=dev)

    def ints(n):
        return torch.randint(0, n, shape, generator=gen, device=dev)

    r, j = uni(), ints(d)
    eps_scam = _normal(gen, shape, cdt, dev)
    z_am = _normal(gen, shape + (d,), cdt, dev)
    scale = _scale_choice(gen, shape, cdt, dev)
    jj = ints(d)
    eps_ss = _normal(gen, shape, cdt, dev)
    a_ix = b_ix = g = None
    if H is not None:
        a_ix = ints(H)
        b_ix = (a_ix + 1 + ints(H - 1)) % H
        g = uni()
    logu = torch.log(_uniform(gen, shape, cdt, dev))
    return RedNoise(r, j, eps_scam, z_am, scale, jj, eps_ss, a_ix, b_ix, g,
                    logu)


def red_mh_block(cm, x, b, gen, U, S, nsteps, hist=None, accepts=None):
    """:func:`red_mh_block_core` with ``nsteps`` steps of noise drawn
    from ``gen``."""
    H = None if hist is None else hist.shape[-2]
    return red_mh_block_core(cm, x, b, U, S,
                             red_noise(cm, gen, x.shape[:-1], nsteps, H),
                             hist, accepts)
