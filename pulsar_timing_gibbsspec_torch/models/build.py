"""Build the CRN free-spectrum PTA model straight from pulsar arrays.

The CRN-spectrum subset of the JAX package's ``models/factory.py::
model_general`` followed by ``sampler/compiled.py::compile_pta``, for

    model_general(psrs, tm_svd=True, white_vary=True,
                  common_psd="spectrum", common_components=nbins,
                  red_var=True, red_psd="spectrum",
                  red_components=red_bins)

(the model of the repo's headline benchmark): an SVD timing-model basis
with marginalized (``BIG_PHI``) columns, a common free spectrum and a
per-pulsar free-spectrum red process sharing the Fourier columns, and
per-backend EFAC/EQUAD.  The arrays, parameter order (sorted by parameter
name, vectors expanded in place), constant pool and padding are those of
``compile_pta``, field by field.
"""

from __future__ import annotations

import numpy as np

from ..data.dataset import get_tspan
from ..data.fourier import fourier_basis
from ..sampler.compiled import BIG_PHI, PHI_FLOOR, from_arrays

#: prior bounds of the model's parameters (model_general's defaults)
_RHO_BOUNDS = (-10.0, -4.0)
_EFAC_BOUNDS = (0.01, 10.0)
_EQUAD_BOUNDS = (-8.5, -5.0)


def _bin_widths(f):
    """Per-column bin width: spacing of the unique frequencies, first
    bin measured from 0."""
    fu = np.unique(f)
    return np.repeat(np.diff(np.concatenate([[0.0], fu])), 2)


def crn_spectrum_arrays(psrs, nbins: int = 10, red_bins: int = 10,
                        pad_pulsars: int | None = None) -> dict:
    """The compiled model's fields as numpy arrays, named as the JAX
    ``CompiledPTA`` names them (the input of
    :func:`~..sampler.compiled.from_arrays`)."""
    psrs = list(psrs)
    for p in psrs:
        if "NANOGrav" in p.flags.get("pta", ""):
            raise NotImplementedError(
                f"{p.name}: ECORR (NANOGrav-flagged data) is not in the "
                "port yet")
    Tspan = get_tspan(psrs)
    P_real = len(psrs)
    P = pad_pulsars or P_real
    if P < P_real:
        raise ValueError("pad_pulsars smaller than the pulsar count")

    # ---- per-pulsar bases and the parameter list ---------------------------
    params = [("gw_crn_log10_rho", nbins) + _RHO_BOUNDS]
    per = []
    for p in psrs:
        M = p.Mmat
        U, _, _ = np.linalg.svd(M / np.linalg.norm(M, axis=0),
                                full_matrices=False)
        Fg, fg = fourier_basis(p.toas / 86400.0, nbins, Tspan)
        Fr, fr = fourier_basis(p.toas / 86400.0, red_bins, Tspan)
        # shared Fourier block: the widest member donates its basis
        donor = Fg if Fg.shape[1] >= Fr.shape[1] else Fr
        labels = sorted(set(p.backend_flags.tolist()))
        masks = {lab: p.backend_flags == lab for lab in labels}
        rname = f"{p.name}_red_noise_log10_rho"
        params.append((rname, red_bins) + _RHO_BOUNDS)
        for lab in labels:
            stem = f"{p.name}_{lab}" if lab else p.name
            params.append((f"{stem}_efac", None) + _EFAC_BOUNDS)
            params.append((f"{stem}_log10_tnequad", None) + _EQUAD_BOUNDS)
        per.append(dict(U=U, Fg=Fg, fg=fg, Fr=Fr, fr=fr, donor=donor,
                        labels=labels, masks=masks, rname=rname))
    params.sort(key=lambda t: t[0])
    names = []
    for nm, size, _, _ in params:
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
    widths = tuple(int(a + b) for a, b in zip(ntms, wf))
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
    gcols = np.full((P, 2 * K), Bmax, np.int32)
    grho = np.full((P, 2 * K), sentinel, np.int32)
    gf = np.ones((P, 2 * K), f32)
    gdf = np.zeros((P, 2 * K), f32)
    rcols = np.full((P, 2 * Kr), Bmax, np.int32)
    rrho = np.full((P, 2 * Kr), sentinel, np.int32)
    rf = np.ones((P, 2 * Kr), f32)
    rdf = np.zeros((P, 2 * Kr), f32)
    gw_sin = np.zeros((P, K), np.int32)
    gw_cos = np.zeros((P, K), np.int32)
    gw_f = np.ones((P, K), f32)
    gw_df = np.zeros((P, K), f32)
    gw_rho = np.full((P, K), floor_ref, np.int32)
    red_rho = np.full((P, Kr), floor_ref, np.int32)
    red_rho_x = np.full((P, Kr), nx, np.int32)
    red_sin = np.zeros((P, Kr), np.int32)
    red_cos = np.zeros((P, Kr), np.int32)
    red_f = np.ones((P, Kr), f32)
    red_df = np.zeros((P, Kr), f32)
    red_valid = np.zeros(P, f32)
    wrows = []

    for ii, (p, d) in enumerate(zip(psrs, per)):
        n, w, ntm = p.ntoa, widths[ii], ntms[ii]
        y[ii, :n] = p.residuals
        T[ii, :n, :w] = np.hstack([d["U"], d["donor"]])
        toa_mask[ii, :n] = 1.0
        basis_mask[ii, :w] = 1.0
        psr_mask[ii] = 1.0
        sigma2[ii, :n] = p.toaerrs ** 2
        wp = []
        for lab in d["labels"]:
            where = np.where(d["masks"][lab])[0]
            stem = f"{p.name}_{lab}" if lab else p.name
            efac_ix[ii, where] = pos[f"{stem}_efac"]
            equad_ix[ii, where] = pos[f"{stem}_log10_tnequad"]
            wp += [pos[f"{stem}_efac"], pos[f"{stem}_log10_tnequad"]]
        wrows.append(sorted(set(wp)))
        phi_base[ii, :ntm] = np.clip(1e40, PHI_FLOOR, BIG_PHI)
        phi_base[ii, ntm:ntm + 2 * K] = 0.0
        phi_base[ii, ntm:ntm + 2 * Kr] = 0.0
        gp_mask[ii, ntm:ntm + 2 * K] = 1.0
        gp_mask[ii, ntm:ntm + 2 * Kr] = 1.0
        gc = np.arange(ntm, ntm + 2 * K)
        rc = np.arange(ntm, ntm + 2 * Kr)
        gcols[ii] = gc
        grho[ii] = [pos[f"gw_crn_log10_rho_{j // 2}"] for j in range(2 * K)]
        gf[ii] = d["fg"]
        gdf[ii] = _bin_widths(d["fg"])
        rcols[ii] = rc
        rrho[ii] = [pos[f"{d['rname']}_{j // 2}"] for j in range(2 * Kr)]
        rf[ii] = d["fr"]
        rdf[ii] = _bin_widths(d["fr"])
        gw_sin[ii], gw_cos[ii] = gc[::2], gc[1::2]
        gw_f[ii], gw_df[ii] = d["fg"][::2], _bin_widths(d["fg"])[::2]
        gw_rho[ii] = [pos[f"gw_crn_log10_rho_{k}"] for k in range(K)]
        red_valid[ii] = 1.0
        red_sin[ii], red_cos[ii] = rc[::2], rc[1::2]
        red_f[ii], red_df[ii] = d["fr"][::2], _bin_widths(d["fr"])[::2]
        red_rho[ii] = [pos[f"{d['rname']}_{k}"] for k in range(Kr)]
        red_rho_x[ii] = red_rho[ii]

    Wp = max(len(r) for r in wrows)
    white_par_ix = np.full((P, max(Wp, 1)), nx, np.int32)
    for ii, r in enumerate(wrows):
        white_par_ix[ii, :len(r)] = r
    white_nper = np.asarray([len(r) for r in wrows] + [0] * (P - P_real),
                            np.int32)

    pkind = np.zeros(nx, np.int32)
    pa = np.zeros(nx, f32)
    pb = np.ones(nx, f32)
    ct = 0
    for _, size, lo, hi in params:
        n = size or 1
        pa[ct:ct + n], pb[ct:ct + n] = lo, hi
        ct += n
    prop_scale = (0.1 * np.abs(pb - pa)).astype(f32)

    rho_lo = 10.0 ** (2.0 * _RHO_BOUNDS[0])
    rho_hi = 10.0 ** (2.0 * _RHO_BOUNDS[1])
    comps = [dict(kind="free_spectrum", cols=gcols, f=gf, df=gdf,
                  hyp_ix=np.zeros((P, 0), np.int32), rho_ix=grho),
             dict(kind="free_spectrum", cols=rcols, f=rf, df=rdf,
                  hyp_ix=np.zeros((P, 0), np.int32), rho_ix=rrho)]
    return dict(
        P=P, P_real=P_real, Nmax=Nmax, Bmax=Bmax, nx=nx, K=K, Kr=Kr,
        widths=widths, param_names=tuple(names), dtype=f32,
        cdtype=np.float64, y=y, T=T, toa_mask=toa_mask,
        basis_mask=basis_mask, psr_mask=psr_mask, sigma2=sigma2,
        efac_ix=efac_ix, equad_ix=equad_ix, gequad_ix=gequad_ix,
        const_pool=const_pool, phi_base=phi_base, components=comps,
        pkind=pkind, pa=pa, pb=pb, prop_scale=prop_scale,
        gw_sin_ix=gw_sin, gw_cos_ix=gw_cos, gw_f=gw_f, gw_df=gw_df,
        gw_kind="free_spectrum",
        gw_hyp_ix=np.full((P, 1), sentinel, np.int32), gw_rho_ix=gw_rho,
        rho_ix_x=np.asarray([pos[f"gw_crn_log10_rho_{k}"]
                             for k in range(K)], np.int32),
        red_valid=red_valid, red_kind="free_spectrum",
        red_hyp_ix=np.full((P, 1), sentinel, np.int32),
        red_rho_ix=red_rho, red_rho_ix_x=red_rho_x,
        red_sin_ix=red_sin, red_cos_ix=red_cos,
        ec_cols=np.zeros((P, 0), np.int32),
        ec_ix=np.zeros((P, 0), np.int32),
        white_par_ix=white_par_ix, white_nper=white_nper,
        ecorr_par_ix=np.full((P, 1), nx, np.int32),
        ecorr_nper=np.zeros(P, np.int32),
        rhomin=rho_lo, rhomax=rho_hi, red_rhomin=rho_lo, red_rhomax=rho_hi,
        orf_name="crn", orf_Ginv=None, gp_mask=gp_mask, red_f=red_f,
        red_df=red_df, orf_B=None, orf_par_ix=None, red_shares_gw=True,
        ke_eid=None, ke_par_ix=None)


def build_crn_spectrum(psrs, nbins: int = 10, red_bins: int = 10,
                       pad_pulsars: int | None = None, device=None):
    """The compiled CRN free-spectrum model of ``psrs`` on ``device``
    (``cuda`` unless the caller passes another)."""
    return from_arrays(crn_spectrum_arrays(psrs, nbins, red_bins,
                                           pad_pulsars), device=device)
