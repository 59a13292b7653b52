"""Build the compiled CRN model straight from pulsar arrays.

The subset of the JAX package's ``models/factory.py::model_general``
followed by ``sampler/compiled.py::compile_pta`` that the port samples:

    model_general(psrs, tm_svd=..., white_vary=True,
                  common_psd="spectrum" | "powerlaw", common_components=K,
                  red_var=..., red_psd="spectrum" | "powerlaw",
                  red_components=Kr, is_wideband=...,
                  upper_limit=..., upper_limit_red=...,
                  upper_limit_common=..., orf="crn" | fixed ORF,
                  orf_ifreq=...)

a timing-model basis with marginalized (``BIG_PHI``) columns (SVD, or
the column-normalized design matrix of ``tm_norm``'s default), a common
process (free spectrum, or a powerlaw with ``log10_A`` ~ U(-18, -11) and
``gamma`` ~ U(0, 7)), optionally a per-pulsar red process sharing the
Fourier columns (free spectrum, or a powerlaw with ``log10_A`` ~ U(-20,
-11)); an upper-limit flag makes an amplitude prior LinearExp over the
same bounds, per-backend EFAC/EQUAD, and, for a pulsar whose ``pta`` flag names
NANOGrav (unless ``is_wideband``), per-backend basis ECORR: one column
per observing epoch per backend (TOAs grouped into epochs of at most 10
days), with prior variance ``10^(2 log10_ecorr)`` of its backend.  The
basis is laid out ``[timing model | Fourier | ECORR]``.  Under a
correlated ORF (``orf="hd"`` and the other fixed ORFs of
:mod:`.orf`) the common free spectrum ``gw_<orf>_log10_rho`` gets
Fourier columns of its own ahead of the red process's, ``[timing model
| common | red | ECORR]``, and the compiled model carries the
per-frequency inverse ORF stack ``orf_Ginv`` (K, P, P), identity on pad
pulsars.  The arrays,
parameter order (sorted by parameter name, vectors expanded in place),
constant pool and padding are those of ``compile_pta``, field by field.
"""

from __future__ import annotations

import numpy as np

from ..data.dataset import get_tspan
from ..data.fourier import DAY, fourier_basis
from ..sampler.compiled import BIG_PHI, PHI_FLOOR, from_arrays
from .orf import orf_ginv_stack, refuse_sampled_weights

#: prior bounds of the model's parameters (model_general's defaults)
_RHO_BOUNDS = (-10.0, -4.0)
_GW_AMP_BOUNDS = (-18.0, -11.0)
_RED_AMP_BOUNDS = (-20.0, -11.0)
_GAMMA_BOUNDS = (0.0, 7.0)
_EFAC_BOUNDS = (0.01, 10.0)
_EQUAD_BOUNDS = (-8.5, -5.0)
_ECORR_BOUNDS = (-8.5, -5.0)
#: widest ECORR epoch (``EcorrBasisSignal``'s ``dt_days``)
ECORR_DT_DAYS = 10.0
#: prior kinds as the compiled ``pkind`` codes them
UNIFORM, NORMAL, LINEAR_EXP = 0, 1, 2
#: the PSDs of the common and red processes the port builds
PSDS = ("spectrum", "powerlaw")


def _bin_widths(f):
    """Per-column bin width: spacing of the unique frequencies, first
    bin measured from 0."""
    fu = np.unique(f)
    return np.repeat(np.diff(np.concatenate([[0.0], fu])), 2)


def _quantize(toas, dt_sec):
    """Group TOAs [s] into epochs no wider than ``dt_sec``, in time
    order: a list of index arrays into ``toas``."""
    if len(toas) == 0:
        return []
    order = np.argsort(toas)
    groups, cur = [], [order[0]]
    for idx in order[1:]:
        if toas[idx] - toas[cur[0]] <= dt_sec:
            cur.append(idx)
        else:
            groups.append(np.array(cur))
            cur = [idx]
    groups.append(np.array(cur))
    return groups


def _ecorr_basis(toas, labels, masks):
    """The basis-ECORR columns of one pulsar: ``(U, owners)``, one 0/1
    column per epoch per backend (backends in label order, epochs in
    time order) and each column's backend label."""
    cols, owners = [], []
    for lab in labels:
        sel = np.where(masks[lab])[0]
        for ep in _quantize(toas[masks[lab]], ECORR_DT_DAYS * DAY):
            col = np.zeros(len(toas))
            col[sel[ep]] = 1.0
            cols.append(col)
            owners.append(lab)
    U = np.column_stack(cols) if cols else np.zeros((len(toas), 0))
    return U, owners


def _has_ecorr(p, is_wideband):
    """The factory's gate: basis ECORR for a NANOGrav-flagged pulsar
    that is not wideband."""
    return "NANOGrav" in p.flags.get("pta", "") and not is_wideband


def _timing_basis(M, tm_svd):
    Mn = M / np.linalg.norm(M, axis=0)
    return np.linalg.svd(Mn, full_matrices=False)[0] if tm_svd else Mn


def _amp_priors(upper_limit, upper_limit_red, upper_limit_common):
    """``(red, common)`` amplitude prior kinds of the factory: with no
    per-class flag both follow ``upper_limit``; once one is given, each
    is LinearExp only under its own flag."""
    if upper_limit_red is None and upper_limit_common is None:
        kind = LINEAR_EXP if upper_limit else UNIFORM
        return kind, kind
    return (LINEAR_EXP if upper_limit_red else UNIFORM,
            LINEAR_EXP if upper_limit_common else UNIFORM)


def model_arrays(psrs, *, tm_svd=False, common_psd="spectrum",
                 common_components=30, red_var=True, red_psd="spectrum",
                 red_components=30, is_wideband=False, upper_limit=False,
                 upper_limit_red=None, upper_limit_common=None,
                 orf="crn", orf_ifreq=0, pad_pulsars=None) -> dict:
    """The compiled model's fields as numpy arrays, named as the JAX
    ``CompiledPTA`` names them (the input of
    :func:`~..sampler.compiled.from_arrays`), for the model of the
    module docstring."""
    for what, psd in (("common_psd", common_psd), ("red_psd", red_psd)):
        if psd not in PSDS:
            raise NotImplementedError(f"{what}={psd!r} is not in the port "
                                      f"yet (it takes {PSDS})")
    orfs = orf.split(",")
    if len(orfs) > 1:
        if set(orfs) - {"crn"} and len(set(orfs)) > 1:
            raise NotImplementedError(
                f"mixed common-process ORFs {set(orfs)}")
        raise NotImplementedError("several common processes are not in the "
                                  "port yet")
    corr = orf != "crn"
    if corr:
        _refuse_orf(orf, common_psd)
    psrs = list(psrs)
    Tspan = get_tspan(psrs)
    P_real = len(psrs)
    P = pad_pulsars or P_real
    if P < P_real:
        raise ValueError("pad_pulsars smaller than the pulsar count")
    nbins = int(common_components)
    red_bins = int(red_components) if red_var else 0
    gw_pl = common_psd == "powerlaw"
    red_pl = red_var and red_psd == "powerlaw"
    amp_red, amp_gw = _amp_priors(upper_limit, upper_limit_red,
                                  upper_limit_common)

    # ---- per-pulsar bases and the parameter list ---------------------------
    # (name, size, prior kind, a, b)
    gname = f"gw_{orf}"
    if gw_pl:
        params = [(f"{gname}_log10_A", None, amp_gw) + _GW_AMP_BOUNDS,
                  (f"{gname}_gamma", None, UNIFORM) + _GAMMA_BOUNDS]
    else:
        params = [(f"{gname}_log10_rho", nbins, UNIFORM) + _RHO_BOUNDS]
    per = []
    for p in psrs:
        U = _timing_basis(p.Mmat, tm_svd)
        Fg, fg = fourier_basis(p.toas / DAY, nbins, Tspan)
        Fr, fr = (fourier_basis(p.toas / DAY, red_bins, Tspan) if red_var
                  else (Fg[:, :0], fg[:0]))
        if corr:
            # a correlated common process keeps its own columns, ahead of
            # the red process's
            donor = np.hstack([Fg, Fr])
        else:
            # shared Fourier block: the widest member donates its basis
            donor = Fg if Fg.shape[1] >= Fr.shape[1] else Fr
        labels = sorted(set(p.backend_flags.tolist()))
        masks = {lab: p.backend_flags == lab for lab in labels}
        rname = f"{p.name}_red_noise"
        if red_pl:
            params.append((f"{rname}_log10_A", None, amp_red)
                          + _RED_AMP_BOUNDS)
            params.append((f"{rname}_gamma", None, UNIFORM) + _GAMMA_BOUNDS)
        elif red_var:
            params.append((f"{rname}_log10_rho", red_bins, UNIFORM)
                          + _RHO_BOUNDS)
        ecorr = _has_ecorr(p, is_wideband)
        for lab in labels:
            stem = f"{p.name}_{lab}" if lab else p.name
            params.append((f"{stem}_efac", None, UNIFORM) + _EFAC_BOUNDS)
            params.append((f"{stem}_log10_tnequad", None, UNIFORM)
                          + _EQUAD_BOUNDS)
            if ecorr:
                params.append((f"{stem}_log10_ecorr", None, UNIFORM)
                              + _ECORR_BOUNDS)
        E, owners = (_ecorr_basis(p.toas, labels, masks) if ecorr
                     else (np.zeros((p.ntoa, 0)), []))
        per.append(dict(U=U, fg=fg, fr=fr, donor=donor, E=E, owners=owners,
                        labels=labels, masks=masks, rname=rname,
                        ecorr=ecorr))
    params.sort(key=lambda t: t[0])
    names = []
    for nm, size, _, _, _ in params:
        names += ([f"{nm}_{k}" for k in range(size)] if size else [nm])
    nx = len(names)
    pos = {nm: ii for ii, nm in enumerate(names)}

    # constant pool in compile_pta's order: efac=1, equad=-40 (pads), then
    # the floor reference 10^(2*-15) == PHI_FLOOR
    sentinel = nx
    efac1, equad_off, floor_ref = nx + 1, nx + 2, nx + 3
    const_pool = np.asarray([1.0, -40.0, -15.0], np.float32)

    ntms = [d["U"].shape[1] for d in per]
    wf = [d["donor"].shape[1] for d in per]
    wes = [d["E"].shape[1] for d in per]
    widths = tuple(int(a + b + c) for a, b, c in zip(ntms, wf, wes))
    Nmax = max(p.ntoa for p in psrs)
    Bmax = max(widths)

    f32 = np.float32
    y = np.zeros((P, Nmax), f32)
    T = np.zeros((P, Nmax, Bmax), f32)
    toa_mask = np.zeros((P, Nmax), f32)
    basis_mask = np.zeros((P, Bmax), f32)
    psr_mask = np.zeros(P, f32)
    sigma2 = np.ones((P, Nmax), f32)
    efac_ix = np.full((P, Nmax), efac1, np.int32)
    equad_ix = np.full((P, Nmax), equad_off, np.int32)
    gequad_ix = np.full((P, Nmax), equad_off, np.int32)
    phi_base = np.ones((P, Bmax), f32)
    gp_mask = np.zeros((P, Bmax), f32)
    K, Kr = nbins, red_bins
    Kr1 = max(Kr, 1)
    gcols = np.full((P, 2 * K), Bmax, np.int32)
    grho = np.full((P, 2 * K), sentinel, np.int32)
    ghyp = np.full((P, 2 if gw_pl else 0), sentinel, np.int32)
    gf = np.ones((P, 2 * K), f32)
    gdf = np.zeros((P, 2 * K), f32)
    rcols = np.full((P, 2 * Kr), Bmax, np.int32)
    rrho = np.full((P, 2 * Kr), sentinel, np.int32)
    rhyp = np.full((P, 2 if red_pl else 0), sentinel, np.int32)
    rf = np.ones((P, 2 * Kr), f32)
    rdf = np.zeros((P, 2 * Kr), f32)
    gw_sin = np.zeros((P, K), np.int32)
    gw_cos = np.zeros((P, K), np.int32)
    gw_f = np.ones((P, K), f32)
    gw_df = np.zeros((P, K), f32)
    gw_rho = np.full((P, K), floor_ref, np.int32)
    gw_hyp = np.full((P, 2 if gw_pl else 1), sentinel, np.int32)
    red_rho = np.full((P, Kr1), floor_ref if Kr else sentinel, np.int32)
    red_rho_x = np.full((P, Kr1), nx, np.int32)
    red_hyp = np.full((P, 2 if red_pl else 1), sentinel, np.int32)
    red_sin = np.zeros((P, Kr1), np.int32)
    red_cos = np.zeros((P, Kr1), np.int32)
    red_f = np.ones((P, Kr1), f32)
    red_df = np.zeros((P, Kr1), f32)
    red_valid = np.zeros(P, f32)
    We = max(wes)
    ecols = np.full((P, We), Bmax, np.int32)
    erho = np.full((P, We), sentinel, np.int32)
    wrows, erows = [], []

    for ii, (p, d) in enumerate(zip(psrs, per)):
        n, ntm, nf, ne = p.ntoa, ntms[ii], wf[ii], wes[ii]
        w = widths[ii]
        y[ii, :n] = p.residuals
        T[ii, :n, :w] = np.hstack([d["U"], d["donor"], d["E"]])
        toa_mask[ii, :n] = 1.0
        basis_mask[ii, :w] = 1.0
        psr_mask[ii] = 1.0
        sigma2[ii, :n] = p.toaerrs ** 2
        wp, ep = [], []
        for lab in d["labels"]:
            where = np.where(d["masks"][lab])[0]
            stem = f"{p.name}_{lab}" if lab else p.name
            efac_ix[ii, where] = pos[f"{stem}_efac"]
            equad_ix[ii, where] = pos[f"{stem}_log10_tnequad"]
            wp += [pos[f"{stem}_efac"], pos[f"{stem}_log10_tnequad"]]
            if d["ecorr"]:
                ep.append(pos[f"{stem}_log10_ecorr"])
        wrows.append(sorted(set(wp)))
        erows.append(sorted(set(ep)))
        phi_base[ii, :ntm] = np.clip(1e40, PHI_FLOOR, BIG_PHI)
        # the red columns start after the common's under a correlated ORF
        r0 = ntm + 2 * K if corr else ntm
        phi_base[ii, ntm:ntm + 2 * K] = 0.0
        phi_base[ii, r0:r0 + 2 * Kr] = 0.0
        phi_base[ii, ntm + nf:ntm + nf + ne] = 0.0
        gp_mask[ii, ntm:ntm + 2 * K] = 1.0
        gp_mask[ii, r0:r0 + 2 * Kr] = 1.0
        gc = np.arange(ntm, ntm + 2 * K)
        gcols[ii] = gc
        gf[ii] = d["fg"]
        gdf[ii] = _bin_widths(d["fg"])
        gw_sin[ii], gw_cos[ii] = gc[::2], gc[1::2]
        gw_f[ii], gw_df[ii] = d["fg"][::2], _bin_widths(d["fg"])[::2]
        if gw_pl:
            ghyp[ii] = gw_hyp[ii] = [pos[f"{gname}_log10_A"],
                                     pos[f"{gname}_gamma"]]
        else:
            grho[ii] = [pos[f"{gname}_log10_rho_{j // 2}"]
                        for j in range(2 * K)]
            gw_rho[ii] = [pos[f"{gname}_log10_rho_{k}"] for k in range(K)]
        if red_var:
            rn = d["rname"]
            rc = np.arange(r0, r0 + 2 * Kr)
            rcols[ii] = rc
            rf[ii] = d["fr"]
            rdf[ii] = _bin_widths(d["fr"])
            red_valid[ii] = 1.0
            red_sin[ii], red_cos[ii] = rc[::2], rc[1::2]
            red_f[ii], red_df[ii] = d["fr"][::2], _bin_widths(d["fr"])[::2]
            if red_pl:
                rhyp[ii] = red_hyp[ii] = [pos[f"{rn}_log10_A"],
                                          pos[f"{rn}_gamma"]]
            else:
                rrho[ii] = [pos[f"{rn}_log10_rho_{j // 2}"]
                            for j in range(2 * Kr)]
                red_rho[ii] = [pos[f"{rn}_log10_rho_{k}"] for k in range(Kr)]
                red_rho_x[ii] = red_rho[ii]
        if ne:
            ecols[ii, :ne] = np.arange(ntm + nf, w)
            erho[ii, :ne] = [pos[f"{p.name}_{lab}_log10_ecorr" if lab
                                 else f"{p.name}_log10_ecorr"]
                             for lab in d["owners"]]

    def table(rows):
        out = np.full((P, max(max(len(r) for r in rows), 1)), nx, np.int32)
        for ii, r in enumerate(rows):
            out[ii, :len(r)] = r
        return out, np.asarray([len(r) for r in rows] + [0] * (P - P_real),
                               np.int32)

    white_par_ix, white_nper = table(wrows)
    ecorr_par_ix, ecorr_nper = table(erows)

    pkind = np.zeros(nx, np.int32)
    pa = np.zeros(nx, f32)
    pb = np.ones(nx, f32)
    ct = 0
    for _, size, kind, lo, hi in params:
        n = size or 1
        pkind[ct:ct + n] = kind
        pa[ct:ct + n], pb[ct:ct + n] = lo, hi
        ct += n
    prop_scale = np.where(pkind == NORMAL, pb,
                          0.1 * np.abs(pb - pa)).astype(f32)

    # the free spectra's variance bounds (compile_pta's defaults without
    # one; the red falls back to the common's)
    if gw_pl:
        rho_lo, rho_hi = 1e-20, 1e-8
    else:
        rho_lo = 10.0 ** (2.0 * _RHO_BOUNDS[0])
        rho_hi = 10.0 ** (2.0 * _RHO_BOUNDS[1])
    if red_var and not red_pl:
        red_lo = 10.0 ** (2.0 * _RHO_BOUNDS[0])
        red_hi = 10.0 ** (2.0 * _RHO_BOUNDS[1])
    else:
        red_lo, red_hi = rho_lo, rho_hi
    comps = [dict(kind="powerlaw" if gw_pl else "free_spectrum", cols=gcols,
                  f=gf, df=gdf, hyp_ix=ghyp, rho_ix=grho)]
    if red_var:
        comps.append(dict(kind="powerlaw" if red_pl else "free_spectrum",
                          cols=rcols, f=rf, df=rdf, hyp_ix=rhyp,
                          rho_ix=rrho))
    if We:
        live = ecols < Bmax
        comps.append(dict(kind="ecorr", cols=ecols,
                          f=np.where(live, 0.0, 1.0).astype(f32),
                          df=np.zeros((P, We), f32),
                          hyp_ix=np.zeros((P, 0), np.int32), rho_ix=erho))
    red_kind = ("powerlaw" if red_pl else "free_spectrum") if red_var else ""
    orf_Ginv = None
    if corr:
        orf_Ginv = np.tile(np.eye(P), (K, 1, 1))
        orf_Ginv[:, :P_real, :P_real] = orf_ginv_stack(
            orf, [p.pos for p in psrs], K, orf_ifreq=orf_ifreq)
    return dict(
        P=P, P_real=P_real, Nmax=Nmax, Bmax=Bmax, nx=nx, K=K, Kr=Kr,
        widths=widths, pulsars=tuple(p.name for p in psrs),
        param_names=tuple(names), dtype=f32,
        cdtype=np.float64, y=y, T=T, toa_mask=toa_mask,
        basis_mask=basis_mask, psr_mask=psr_mask, sigma2=sigma2,
        efac_ix=efac_ix, equad_ix=equad_ix, gequad_ix=gequad_ix,
        const_pool=const_pool, phi_base=phi_base, components=comps,
        pkind=pkind, pa=pa, pb=pb, prop_scale=prop_scale,
        gw_sin_ix=gw_sin, gw_cos_ix=gw_cos, gw_f=gw_f, gw_df=gw_df,
        gw_kind="powerlaw" if gw_pl else "free_spectrum",
        gw_hyp_ix=gw_hyp, gw_rho_ix=gw_rho,
        rho_ix_x=(np.zeros(0, np.int32) if gw_pl else np.asarray(
            [pos[f"{gname}_log10_rho_{k}"] for k in range(K)], np.int32)),
        red_valid=red_valid, red_kind=red_kind, red_hyp_ix=red_hyp,
        red_rho_ix=red_rho, red_rho_ix_x=red_rho_x,
        red_sin_ix=red_sin, red_cos_ix=red_cos,
        ec_cols=ecols, ec_ix=erho,
        white_par_ix=white_par_ix, white_nper=white_nper,
        ecorr_par_ix=ecorr_par_ix, ecorr_nper=ecorr_nper,
        rhomin=rho_lo, rhomax=rho_hi, red_rhomin=red_lo, red_rhomax=red_hi,
        orf_name=orf, orf_Ginv=orf_Ginv, gp_mask=gp_mask, red_f=red_f,
        red_df=red_df, orf_B=None, orf_par_ix=None,
        red_shares_gw=not (corr and red_var), ke_eid=None, ke_par_ix=None)


def _refuse_orf(orf, common_psd):
    """What ``compile_pta`` refuses of a correlated ORF, with its
    messages, and the sampled-weight ORFs the port does not take yet."""
    if orf.startswith("zero_diag_"):
        raise NotImplementedError(
            f"orf='{orf}' builds (fixed-amplitude detection-"
            "statistic model) but cannot be *sampled*: the zero-"
            "diagonal correlation is not a positive-definite "
            "coefficient prior.  Evaluate it with your own "
            "likelihood machinery, or sample the full-diagonal "
            f"'{orf[len('zero_diag_'):]}' instead")
    if common_psd != "spectrum":
        raise NotImplementedError(
            "correlated ORF is implemented for a varied common free "
            "spectrum (common_psd='spectrum'); the powerlaw-family "
            "HD marginalized-likelihood MH block is not implemented")
    refuse_sampled_weights(orf)


def crn_spectrum_arrays(psrs, nbins: int = 10, red_bins: int = 10,
                        pad_pulsars: int | None = None) -> dict:
    """The arrays of the repository's headline model: SVD timing model,
    a common and a per-pulsar red free spectrum (``nbins`` /
    ``red_bins``), EFAC/EQUAD and, for NANOGrav-flagged pulsars, ECORR."""
    return model_arrays(psrs, tm_svd=True, common_components=nbins,
                        red_var=True, red_components=red_bins,
                        pad_pulsars=pad_pulsars)


def build_crn_spectrum(psrs, nbins: int = 10, red_bins: int = 10,
                       pad_pulsars: int | None = None, device=None):
    """The compiled model of :func:`crn_spectrum_arrays` on ``device``
    (``cuda`` unless the caller passes another)."""
    return from_arrays(crn_spectrum_arrays(psrs, nbins, red_bins,
                                           pad_pulsars), device=device)


def model_general(psrs, tm_svd=False, white_vary=False,
                  common_psd="powerlaw", common_components=30,
                  red_var=True, red_psd="powerlaw", red_components=30,
                  is_wideband=False, upper_limit=False, upper_limit_red=None,
                  upper_limit_common=None, orf="crn", orf_ifreq=0,
                  device=None):
    """The compiled model of the JAX package's ``model_general`` with
    these options (its defaults) followed by ``compile_pta``, on
    ``device`` (``cuda`` unless the caller passes another).  The port
    takes ``white_vary=True``, ``common_psd`` and ``red_psd`` of
    ``"spectrum"`` or ``"powerlaw"``, and the upper-limit flags (LinearExp
    amplitude priors); any other PSD, or fixed white noise, raises
    ``NotImplementedError``.  ``orf`` takes ``"crn"`` and the fixed
    positive-definite ORFs (``hd``, ``freq_hd`` with ``orf_ifreq``,
    ``st``, ``gw_monopole``, ``gw_dipole``) under a common free spectrum.
    README's Quick start, the standard PTA noise model (a free spectrum
    with intrinsic powerlaw red noise) and ``bench.py``'s Hellings-Downs
    array::

        model_general([psr], red_var=False, white_vary=True,
                      common_psd="spectrum", common_components=30)
        model_general([psr], white_vary=True, common_psd="spectrum",
                      red_psd="powerlaw")
        model_general(psrs, tm_svd=True, white_vary=True,
                      common_psd="spectrum", common_components=10,
                      red_psd="spectrum", red_components=10, orf="hd")
    """
    if not white_vary:
        raise NotImplementedError(
            "fixed white noise (white_vary=False) is not in the port yet")
    return from_arrays(model_arrays(
        psrs, tm_svd=tm_svd, common_psd=common_psd,
        common_components=common_components, red_var=red_var,
        red_psd=red_psd, red_components=red_components,
        is_wideband=is_wideband, upper_limit=upper_limit,
        upper_limit_red=upper_limit_red,
        upper_limit_common=upper_limit_common, orf=orf,
        orf_ifreq=orf_ifreq), device=device)
