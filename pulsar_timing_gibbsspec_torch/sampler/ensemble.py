"""The ensemble stage: interchain stretch moves, ASIS interweaving and
parallel tempering on the chain axis.

The port of ``pulsar_timing_gibbsspec_tpu/sampler/ensemble.py``.  The
driver's chains are one batch, an *ensemble*; this stage, appended to
each steady sweep after the sweep's blocks, exploits it against the
rho <-> b funnel of the common free spectrum:

- :func:`asis_rho_redraw` (Yu & Meng 2011): with the prior diagonal,
  ``b~ = b / sqrt(phi)`` on the shared common columns is the exact
  ancillary coordinate; holding it fixed, ``rho_k``'s conditional on the
  log-uniform grid is a per-pulsar two-scalar (A_p, B_p) white-likelihood
  profile, drawn exactly by Gumbel-max.  The sweep's ``rho`` draw is the
  sufficient one; this is the ancillary one.
- :func:`stretch_rho_move` (Goodman & Weare 2010): affine-invariant
  stretch proposals on the ln-rho block, paired across complementary
  half-ensembles of each temperature group.  Given b, rho's conditional
  is a (P, K) prior reduction, the same at every temperature.
- :func:`pt_swap`: parallel tempering over a temperature sub-axis of the
  chains.  Chain ``c = w * T + t`` runs at ``betas[c % T]`` (a geometric
  ladder adapted toward ~23% swap acceptance by stochastic approximation
  with decaying gain), with even/odd deck swaps of the whole ``(x, b,
  u)`` state between adjacent rungs.  Only the likelihood is tempered:
  beta enters the white and ECORR MH log-likelihoods, the b-draws' system
  (``N -> N / beta``), the scale moves' residual delta (``blocks``) and
  the swap energy.  Only ``beta = 1`` chains (``c % T == 0``) are
  posterior samples.

Each random piece has a ``*_core`` that takes its noise as tensors (the
tests feed it the JAX-drawn noise) and a wrapper that draws it from a
``torch.Generator``.  The stage's state (:func:`init_ens_state`: the
ladder's log-spacings and the swap and stretch counters) is a dict of
small float64 tensors; the driver keeps it in static device buffers that
the stage updates in place, and checkpoints it as ``ens_*`` keys.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import settings
from . import blocks

_LN10 = math.log(10.0)
#: the block timer's name of each stage block of the driver (the
#: tempering swap has a block of each parity)
TIMER_NAME = {"pt_swap_even": "pt_swap", "pt_swap_odd": "pt_swap"}


@dataclasses.dataclass(frozen=True)
class EnsembleSpec:
    """Static configuration of the ensemble stage."""

    n_temps: int = 1
    stretch: bool = True
    asis: bool = True
    #: Goodman-Weare stretch scale: z ~ g(z) ~ 1/sqrt(z) on [1/a, a]
    stretch_a: float = 2.0
    #: PT swap-acceptance target of the stochastic-approximation ladder
    swap_target: float = 0.23
    #: SA gain schedule gain_m = sa_gain / (1 + m / sa_t0)^0.6
    sa_gain: float = 0.5
    sa_t0: float = 50.0
    #: initial geometric ladder ratio beta_{t+1} / beta_t
    beta_ratio: float = 0.55


def ensemble_applies(cm) -> bool:
    """CRN free-spectrum common block with a sampled rho and diagonal N
    (the scale moves' applicability class)."""
    return (cm.orf_name == "crn" and cm.gw_kind == "free_spectrum"
            and bool(cm.K) and len(cm.rho_ix_x) > 0 and not cm.has_ke)


def validate_ensemble(spec: EnsembleSpec, nchains: int):
    """Raise ``ValueError`` unless the chains factor into the (walker,
    temperature) layout the stage assumes."""
    T = int(spec.n_temps)
    if T < 1:
        raise ValueError(f"pt_ladder={T} must be >= 1")
    if nchains % T:
        raise ValueError(
            f"nchains={nchains} is not a multiple of the tempering "
            f"ladder depth {T} — chain c runs at betas[c % {T}], so the "
            "ladder must tile the chain batch exactly")
    W = nchains // T
    if spec.stretch and (W < 2 or W % 2):
        raise ValueError(
            f"stretch moves need an even number >= 2 of walkers per "
            f"temperature (half-ensemble pairing); got {W} "
            f"(nchains={nchains}, pt_ladder={T})")


def init_ens_state(spec: EnsembleSpec, dtype=torch.float64,
                   device="cpu") -> dict:
    """The stage's state: the ladder's log-spacings ``lsp`` (T-1), the
    SA step count ``m``, per-rung swap accepts and tries (T-1), and
    per-temperature stretch accepts (T) and tries."""
    T = int(spec.n_temps)
    lsp0 = float(np.log(np.log(1.0 / spec.beta_ratio)))

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"lsp": torch.full((max(T - 1, 0),), lsp0, dtype=dtype,
                              device=device),
            "m": z(), "swap_acc": z(max(T - 1, 0)),
            "swap_try": z(max(T - 1, 0)), "stretch_acc": z(T),
            "stretch_try": z()}


def betas_from_lsp(lsp):
    """The inverse-temperature ladder ``beta_t = exp(-sum_{s<t}
    exp(lsp_s))``: ``beta_0 = 1``, each spacing positive, so adaptation
    can never reorder or collapse the ladder."""
    one = torch.ones(1, dtype=lsp.dtype, device=lsp.device)
    return torch.cat([one, torch.exp(-torch.cumsum(torch.exp(lsp), 0))])


def chain_betas(spec: EnsembleSpec, es: dict, nchains: int):
    """(C,) per-chain inverse temperatures under ``c = w * T + t``."""
    return betas_from_lsp(es["lsp"]).repeat(nchains // spec.n_temps)


# ---------------------------------------------------------------------------
# stretch move

def stretch_halves_core(logpdf, coords, j_off, zu, ua, a=2.0):
    """One Goodman-Weare stretch sweep of an ensemble ``coords`` (W, G,
    d) (walkers x independent groups x dimension): two complementary
    half updates, each walker's partner from the other half, accepted
    with the Jacobian ``z^(d-1)``.  ``logpdf(c, lo)`` maps proposals
    (m, G, d) of walkers ``lo .. lo + m`` to log densities (m, G).

    Noise per half (leading axis 2): ``j_off`` (2, h, G) integers in
    ``[0, W - h)`` (the partner's place in the other half), ``zu`` and
    ``ua`` (2, h, G) uniforms (the stretch and the accept).  Returns
    ``(coords, n_accept)``, ``n_accept`` (G,) summed per group."""
    W, G, d = coords.shape
    h = W // 2

    def half(coords, lo, co, jo, zh, uh):
        cs = coords[lo:lo + h]
        j = co + jo
        cp = torch.gather(coords, 0, j[..., None].expand(h, G, d))
        z = ((a - 1.0) * zh + 1.0) ** 2 / a
        prop = cp + z[..., None] * (cs - cp)
        logr = (d - 1.0) * torch.log(z) + logpdf(prop, lo) - logpdf(cs, lo)
        acc = torch.log(uh) < logr
        new = torch.where(acc[..., None], prop, cs)
        coords = torch.cat([coords[:lo], new, coords[lo + h:]])
        return coords, acc.sum(0).to(coords.dtype)

    coords, a0 = half(coords, 0, h, j_off[0], zu[0], ua[0])
    coords, a1 = half(coords, h, 0, j_off[1], zu[1], ua[1])
    return coords, a0 + a1


def stretch_noise(gen, W, G, dtype, device):
    """The noise of :func:`stretch_halves_core` for ``W`` walkers in
    ``G`` groups, drawn from ``gen``."""
    h = W // 2
    shape = (2, h, G)
    j_off = torch.randint(0, W - h, shape, generator=gen, device=device)
    zu = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    ua = blocks._uniform(gen, shape, dtype, device)
    return j_off, zu, ua


def _gw_coeff_counts(cm):
    """(P, K) live common coefficients per (pulsar, frequency): the ``n``
    of the rho conditional ``phi^(-n/2) exp(-tau/phi)``."""
    B = cm.Bmax
    live = cm.psr_mask.to(cm.cdtype)[:, None]
    gs, gc = cm.gw_sin_ix, cm.gw_cos_ix
    return (((gs >= 0) & (gs < B)).to(cm.cdtype) * live
            + ((gc >= 0) & (gc < B)).to(cm.cdtype) * live)


def stretch_rho_move_core(cm, spec: EnsembleSpec, x, b, j_off, zu, ua):
    """Interchain stretch move on the common ln-rho block of the (C, nx)
    chains: target per chain ``sum_pk -tau/phi - n/2 log phi`` with ``phi
    = rho + red`` (b fixed; the same at every temperature), pairing inside
    each temperature group.  Noise as :func:`stretch_halves_core`'s with
    ``W = C / T``, ``G = T``.  Returns ``(x, n_accept per temperature)``."""
    cdt = cm.cdtype
    C = x.shape[0]
    T, K, P = spec.n_temps, cm.K, cm.P
    Wn = C // T
    rix = cm.rho_ix_x
    lnlo, lnhi = math.log(cm.rhomin), math.log(cm.rhomax)
    nv = _gw_coeff_counts(cm)
    lvec = (2.0 * _LN10 * x[:, rix].to(cdt)).reshape(Wn, T, K)
    tau = cm.gw_tau(b).to(cdt).reshape(Wn, T, P, K)
    redv = cm.red_phi(x).to(cdt).reshape(Wn, T, P, K)
    zero = torch.zeros((), dtype=cdt, device=x.device)

    def logpdf(c, lo):
        m = c.shape[0]
        phi = torch.exp(c)[:, :, None, :] + redv[lo:lo + m]
        val = -tau[lo:lo + m] / phi - 0.5 * nv * torch.log(phi)
        lp = torch.where(nv > 0, val, zero).sum((-2, -1))
        inb = ((c > lnlo) & (c < lnhi)).all(-1)
        return torch.where(inb, lp, torch.full_like(lp, -math.inf))

    lnew, nacc = stretch_halves_core(logpdf, lvec, j_off, zu, ua,
                                     a=spec.stretch_a)
    x = x.clone()
    x[:, rix] = (0.5 / _LN10 * lnew.reshape(C, K)).to(x.dtype)
    return x, nacc


def stretch_rho_move(cm, spec: EnsembleSpec, x, b, gen):
    """:func:`stretch_rho_move_core` with its noise drawn from ``gen``."""
    noise = stretch_noise(gen, x.shape[0] // spec.n_temps, spec.n_temps,
                          cm.cdtype, cm.device)
    return stretch_rho_move_core(cm, spec, x, b, *noise)


# ---------------------------------------------------------------------------
# ASIS ancillary redraw

def asis_rho_redraw_core(cm, x, b, u, gumbel, beta=None):
    """Exact ancillary redraw of the common rho block, batched over the
    chains: per frequency k (in order), ``b~ = b / sqrt(phi)`` on the
    shared columns held fixed, ``ln rho_k | b~`` drawn on the rho grid by
    Gumbel-max from the white-likelihood profile ``beta * sum_p [delta_p
    A_p - delta_p^2 B_p / 2]``, ``delta_p = s_p - 1``, ``s_p = sqrt((rho'
    + red_p) / (rho + red_p))``, ``A_p = sum r t / N``, ``B_p = sum t^2 /
    N``, ``t`` the pulsar's two-column product.  b, u and x are updated
    consistently (u by the rank-1 column shift).  ``gumbel`` (..., K, R)
    in the storage dtype; ``beta`` (...,) scales the profile (None:
    untempered)."""
    cdt, fdt = cm.cdtype, cm.dtype
    B, P, K = cm.Bmax, cm.P, cm.K
    live = cm.psr_mask.to(cdt)
    redv = cm.red_phi(x)
    invN = cm.toa_mask / cm.ndiag_fast(x)
    grid = blocks._rho_grid(cm, cm.rhomin, cm.rhomax)
    grid_c = grid.to(cdt)
    pr = torch.arange(P, device=cm.device)
    zero = torch.zeros((), dtype=fdt, device=cm.device)
    x, b = x.clone(), b.clone()
    for k in range(K):
        gs, gc = cm.gw_sin_ix[:, k], cm.gw_cos_ix[:, k]
        sk = torch.clamp(gs, 0, B - 1)
        ck = torch.clamp(gc, 0, B - 1)
        vs = ((gs >= 0) & (gs < B)).to(cdt) * live
        vc = ((gc >= 0) & (gc < B)).to(cdt) * live
        bs = blocks._take_cols(b, sk) * vs
        bc = blocks._take_cols(b, ck) * vc
        t = (cm.T[pr, :, sk] * bs.to(fdt)[..., None]
             + cm.T[pr, :, ck] * bc.to(fdt)[..., None])
        r = cm.y - u
        A = (r * t * invN).sum(-1)
        Bq = (t * t * invN).sum(-1)
        # a (1,) index: a 0-d device index would be read on the host
        rix = cm.rho_ix_x[k:k + 1]
        xr = x.index_select(-1, rix)[..., 0]
        red_k = redv[..., min(k, K - 1)]
        phi0 = torch.exp(2.0 * _LN10 * xr.to(cdt))[..., None] + red_k
        nv = vs + vc
        s = torch.sqrt((grid_c + red_k[..., None]) / phi0[..., None])
        dl = (s - 1.0).to(fdt)
        lg = torch.where((nv > 0)[:, None],
                         dl * A[..., None] - 0.5 * dl * dl * Bq[..., None],
                         zero).sum(-2)
        if beta is not None:
            lg = lg * beta.to(fdt)[..., None]
        rnew = grid[torch.argmax(lg + gumbel[..., k, :], dim=-1)]
        snew = torch.sqrt((rnew.to(cdt)[..., None] + red_k) / phi0)
        dnew = (snew - 1.0).to(fdt)
        for ix, v in ((sk, vs), (ck, vc)):
            cur = blocks._take_cols(b, ix)
            new = torch.where(v > 0, cur * snew, cur)
            b = b.scatter(-1, ix[:, None].expand(b.shape[:-1] + (1,)),
                          new[..., None])
        u = u + dnew[..., None] * t
        x.index_copy_(-1, rix, (0.5 * torch.log10(rnew)).to(x.dtype)[
            ..., None])
    return x, b, u


def asis_rho_redraw(cm, x, b, u, gen, beta=None):
    """:func:`asis_rho_redraw_core` with its Gumbels drawn from
    ``gen``."""
    shape = x.shape[:-1] + (cm.K, settings.rho_grid_size)
    return asis_rho_redraw_core(
        cm, x, b, u, blocks._gumbel(gen, shape, cm.dtype, cm.device), beta)


# ---------------------------------------------------------------------------
# parallel tempering

def _partner_table(T, parity):
    """Adjacent-rung pairing: rung r <-> r+1 for r = parity (mod 2);
    unpaired rungs map to themselves."""
    out = np.arange(T)
    for r in range(parity, T - 1, 2):
        out[r], out[r + 1] = r + 1, r
    return out


_PARTNERS: dict = {}


def _partner(T, parity, device):
    """The pairing of :func:`_partner_table` as a device tensor, made once
    per (T, parity, device): a CUDA graph capture cannot copy it from
    the host."""
    key = (int(T), int(parity), str(device))
    if key not in _PARTNERS:
        _PARTNERS[key] = torch.as_tensor(_partner_table(T, parity),
                                         device=device)
    return _PARTNERS[key]


def swap_energy(cm, x, u):
    """(C,) swap energy of each chain: the data log-likelihood ``-0.5 sum
    (r^2 / N + log N)`` (everything beta multiplies; the prior is
    untempered), summed in the storage dtype as the JAX stage sums it."""
    toam = cm.toa_mask
    Nf = torch.where(toam > 0, cm.ndiag_fast(x), torch.ones_like(toam))
    r = cm.y - u
    val = torch.where(toam > 0, r * r / Nf + torch.log(Nf),
                      torch.zeros_like(r))
    return (-0.5 * val.sum((-2, -1))).to(cm.cdtype)


def pt_swap_core(spec: EnsembleSpec, x, b, u, es, ll, un, t):
    """Even/odd deck swaps of the whole ``(x, b, u)`` state between
    adjacent rungs (parity ``t % 2`` of the iteration ``t``), and the SA
    ladder update.  ``ll`` (C,) the swap energies (:func:`swap_energy`),
    ``un`` (C / T, T) uniforms, one per pair (the lower rung's).  The
    accept of pair (r, r+1) is ``(beta_r - beta_{r+1}) (E_{r+1} -
    E_r)``; the log-spacings move by ``gain_m (pbar_r - target)`` on the
    rungs active this sweep and are clipped to ``[log 0.01, log 5]``.
    Returns ``(x, b, u, es)``."""
    T = spec.n_temps
    C = x.shape[0]
    Wn = C // T
    cdt = es["lsp"].dtype
    betas = betas_from_lsp(es["lsp"])
    lw = ll.reshape(Wn, T)
    ar = torch.arange(T, device=x.device)
    partner = _partner(T, int(t) % 2, x.device)
    la = (betas - betas[partner])[None, :] * (lw[:, partner] - lw)
    ush = un[:, torch.minimum(ar, partner)]
    acc = (torch.log(ush) < la) & (partner != ar)[None, :]

    def sw(a):
        aw = a.reshape((Wn, T) + a.shape[1:])
        m = acc.reshape(acc.shape + (1,) * (aw.dim() - 2))
        return torch.where(m, aw[:, partner], aw).reshape(a.shape)

    x, b, u = sw(x), sw(b), sw(u)
    active = partner[:-1] == ar[:-1] + 1
    pbar = torch.clamp(torch.exp(la[:, :-1]), max=1.0).mean(0)
    m = es["m"] + 1.0
    gain = spec.sa_gain / (1.0 + m / spec.sa_t0) ** 0.6
    lsp = es["lsp"] + gain * torch.where(
        active, pbar - spec.swap_target, torch.zeros_like(pbar))
    lsp = torch.clamp(lsp, math.log(0.01), math.log(5.0))
    es = {**es, "lsp": lsp, "m": m,
          "swap_acc": es["swap_acc"] + acc[:, :-1].sum(0).to(cdt),
          "swap_try": es["swap_try"] + torch.where(
              active, float(Wn), 0.0).to(cdt)}
    return x, b, u, es


def pt_swap(cm, spec: EnsembleSpec, x, b, u, es, gen, t):
    """:func:`pt_swap_core` at this state's energies, its uniforms drawn
    from ``gen``."""
    T = spec.n_temps
    un = blocks._uniform(gen, (x.shape[0] // T, T), cm.cdtype, cm.device)
    return pt_swap_core(spec, x, b, u, es, swap_energy(cm, x, u), un, t)


# ---------------------------------------------------------------------------
# the stage

def _stretch_counts(spec, es, nacc, C):
    return {**es, "stretch_acc": es["stretch_acc"] + nacc.to(
        es["stretch_acc"].dtype),
        "stretch_try": es["stretch_try"] + float(C // spec.n_temps)}


def ensemble_stage_core(cm, spec: EnsembleSpec, x, b, u, es, t,
                        gumbel=None, stretch=None, un=None):
    """The stage after one steady sweep: the ASIS redraw (per chain, at
    its beta when tempering), the stretch move, then the tempering swaps
    at iteration ``t``, each with its noise as the cores take it
    (``stretch`` the triple of :func:`stretch_noise`).  Returns ``(x, b,
    u, es)``."""
    C = x.shape[0]
    tempered = spec.n_temps > 1
    if spec.asis:
        beta = chain_betas(spec, es, C) if tempered else None
        x, b, u = asis_rho_redraw_core(cm, x, b, u, gumbel, beta)
    if spec.stretch:
        x, nacc = stretch_rho_move_core(cm, spec, x, b, *stretch)
        es = _stretch_counts(spec, es, nacc, C)
    if tempered:
        x, b, u, es = pt_swap_core(spec, x, b, u, es,
                                   swap_energy(cm, x, u), un, t)
    return x, b, u, es


def ensemble_stage(cm, spec: EnsembleSpec, x, b, u, es, gen, t):
    """:func:`ensemble_stage_core` with its noise drawn from ``gen``, in
    the order the driver's stage blocks draw it."""
    C = x.shape[0]
    tempered = spec.n_temps > 1
    if spec.asis:
        beta = chain_betas(spec, es, C) if tempered else None
        x, b, u = asis_rho_redraw(cm, x, b, u, gen, beta)
    if spec.stretch:
        x, nacc = stretch_rho_move(cm, spec, x, b, gen)
        es = _stretch_counts(spec, es, nacc, C)
    if tempered:
        x, b, u, es = pt_swap(cm, spec, x, b, u, es, gen, t)
    return x, b, u, es


def ensemble_summary(spec: EnsembleSpec, es) -> dict:
    """Host roll-up of the stage's counters: per-rung swap rates,
    per-temperature stretch acceptance, the current ladder."""
    es = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float64)
          for k, v in es.items()}
    lsp = es["lsp"]
    betas = np.concatenate([[1.0], np.exp(-np.cumsum(np.exp(lsp)))])
    st = float(es["stretch_try"])
    return {
        "n_temps": int(spec.n_temps),
        "stretch": bool(spec.stretch),
        "asis": bool(spec.asis),
        "stretch_a": float(spec.stretch_a),
        "betas": [float(v) for v in betas],
        "swap_rate": [float(a / max(n, 1.0))
                      for a, n in zip(es["swap_acc"], es["swap_try"])],
        "stretch_accept": [float(a / max(st, 1.0))
                           for a in es["stretch_acc"]],
        "sa_steps": float(es["m"]),
    }
