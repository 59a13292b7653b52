"""Build the compiled model straight from pulsar arrays.

The port's form of the JAX package's ``models/factory.py::model_general``
followed by ``sampler/compiled.py::compile_pta``: the per-pulsar signal
model of ``model_general`` (timing model, common process, intrinsic red
noise, chromatic DM and scattering GPs, the annual DM sinusoid,
BayesEphem, white noise and basis ECORR), laid out and compiled into the
padded arrays, parameter order (sorted by name, vectors expanded in
place), constant pool and index tables of ``compile_pta``, field by
field.

Per pulsar the basis is ``[timing model | dm_annual | bayesephem |
Fourier | chromatic and split red | ECORR]``, every Fourier GP on the
grid of ``Tspan``, ``modes`` or ``logfreq``:

- the timing model (SVD, or the column-normalized design matrix of
  ``tm_norm``'s default), the two ``nu^-2`` sin/cos columns of
  ``dm_annual`` and the 11 sigma-scaled ephemeris columns of
  ``bayesephem`` (:mod:`.ephem`) are static, marginalized columns whose
  prior variance ``phi_base`` is constant: 1e40 clipped to ``BIG_PHI``
  for the first two, 1 for the ephemeris;
- the common process and intrinsic red noise share the Fourier columns
  (the widest donates its basis), except under a correlated ORF, where
  the common free spectrum keeps columns of its own ahead of the red
  noise's; their PSD is a free spectrum or one of the powerlaw family
  (``powerlaw``, ``turnover``, ``turnover_knee``, ``broken_powerlaw``,
  and ``powerlaw_breakflat`` for ``red_breakflat``), whose shape
  hypers beyond ``(log10_A, gamma)`` are constants;
- each chromatic GP (``dm_var``: ``(1400/nu)^2``; ``dm_chrom``:
  ``(1400/nu)^dmchrom_idx``) has columns of its own and a powerlaw-
  family PSD whose ``log10_A``/``gamma`` join the powerlaw hyper block;
- basis ECORR (a NANOGrav-flagged pulsar, unless ``is_wideband``): one
  column per observing epoch (TOAs within 10 days) per backend; under
  ``kernel_ecorr`` those columns leave T and the epochs are compiled
  into ``ke_eid`` / ``ke_par_ix`` for the in-N (Woodbury) ECORR of the
  ``ecorrsample="kernel"`` sweep.

Intrinsic red noise is a free spectrum, a powerlaw (flat above a break
under ``red_breakflat``), the t-process (a powerlaw scaled per frequency
by ``alphas ~ InvGamma(1, 1)``, prior kind 3) or ``infinitepower``
(``BIG_PHI`` on its columns, no hypers); under ``red_select`` a
powerlaw-family GP per radio band or backend, its rows outside the group
zeroed, on columns of its own like a chromatic GP.

White noise is per-backend EFAC/EQUAD (and a global ``gequad``), with
ECORR sampled under ``white_vary=True`` and otherwise fixed from a noise
dictionary (``<pulsar>_<backend>_efac``, ``..._log10_tnequad``,
``..._log10_ecorr``, ``<pulsar>_log10_gequad``; 1.0 and -40 where a key
is missing).  Fixed values and constant shape hypers live in the
constant pool, in ``compile_pta``'s order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import current_settings
from ..data.dataset import get_tspan
from ..data.fourier import DAY, fourier_basis, pshift_phases, pshift_seed
from ..sampler.compiled import BIG_PHI, PHI_FLOOR, from_arrays
from .ephem import bayesephem_basis
from .orf import BIN_ORF_EDGES, orf_ginv_stack, orf_param_basis

#: widest ECORR epoch (``EcorrBasisSignal``'s ``dt_days``)
ECORR_DT_DAYS = 10.0
#: prior kinds as the compiled ``pkind`` codes them
UNIFORM, NORMAL, LINEAR_EXP, INV_GAMMA = 0, 1, 2, 3
#: the powerlaw family's hypers, in the order their PSDs take them
PSD_HYPERS = {
    "powerlaw": ("log10_A", "gamma"),
    "turnover": ("log10_A", "gamma", "lf0", "kappa"),
    "turnover_knee": ("log10_A", "gamma", "lfb", "lfk", "kappa", "delta"),
    "broken_powerlaw": ("log10_A", "gamma", "delta", "log10_fb", "kappa"),
}
#: the constant values of the shape hypers beyond (log10_A, gamma)
PSD_SHAPE_DEFAULTS = {
    "turnover": {"lf0": -8.5, "kappa": 10.0 / 3.0},
    "turnover_knee": {"lfb": -8.5, "lfk": -8.0, "kappa": 10.0 / 3.0,
                      "delta": 0.1},
    "broken_powerlaw": {"delta": 0.0, "log10_fb": -8.5, "kappa": 0.1},
}
#: the year of ``dm_annual``'s sinusoid [s]
YEAR = 365.25 * 86400.0
#: ``red_select`` band edges [MHz] (the JAX ``factory.py::_BANDS``): cut
#: on radio frequency, below/above 1 GHz, and for ``band+`` an L/S split
BANDS = {
    "band": (("low", 0.0, 1000.0), ("high", 1000.0, np.inf)),
    "band+": (("low", 0.0, 1000.0), ("mid", 1000.0, 2000.0),
              ("high", 2000.0, np.inf)),
}


def log_grid(nmodes_lin, nmodes_log, Tspan):
    """``logfreq``'s grid: ``nmodes_log`` log-spaced frequencies below
    ``1/Tspan`` (from a hundredth of it) joined to the linear grid."""
    flin = np.arange(1, nmodes_lin + 1) / Tspan
    flog = np.logspace(np.log10(flin[0] / 100.0), np.log10(flin[0]),
                       nmodes_log, endpoint=False)
    return np.concatenate([flog, flin])


def _selection(select, backend_flags):
    """White-noise TOA groups: one per backend (``"backend"``) or one
    for all TOAs (``None`` / ``"none"``, label ``""``); another value
    raises ``KeyError``, as the JAX ``SELECTIONS`` table does."""
    if select not in ("backend", None, "none"):
        raise KeyError(select)
    if select == "backend":
        return {lab: backend_flags == lab
                for lab in sorted(set(backend_flags.tolist()))}
    return {"": np.ones(len(backend_flags), dtype=bool)}


@dataclasses.dataclass(frozen=True)
class _Par:
    """A sampled parameter: ``size`` entries (None: a scalar) under a
    prior of kind ``kind`` with bounds ``(lo, hi)``."""

    name: str
    size: int | None
    kind: int
    lo: float
    hi: float
    #: where an initial sample starts it (None: a prior draw)
    init: float | None = None


def _orf_weights(orf, gname, leg_lmax):
    """The sampled weights of ``orf`` (``model_general``'s
    ``<gname>_orfw_bin_<j>`` / ``_orfw_leg_<l>``): ``Uniform(-1, 1)``,
    starting at 0 (``G = I``: a prior draw is non-positive-definite with
    high probability, and the MH block cannot leave a non-PD start); none
    for a fixed ORF.  A ``zero_diag_`` variant carries its full
    counterpart's weights."""
    base = orf[len("zero_diag_"):] if orf.startswith("zero_diag_") else orf
    if base == "bin_orf":
        labels = [f"bin_{j}" for j in range(len(BIN_ORF_EDGES) - 1)]
    elif base == "legendre_orf":
        labels = [f"leg_{l}" for l in range(leg_lmax + 1)]
    else:
        return []
    return [_Par(f"{gname}_orfw_{lab}", None, UNIFORM, -1.0, 1.0, init=0.0)
            for lab in labels]


@dataclasses.dataclass(frozen=True)
class _Fixed:
    """A constant parameter (enterprise's ``Constant``)."""

    name: str
    value: float


@dataclasses.dataclass
class _Signal:
    """One basis signal of a pulsar: ``group`` is ``"static"``, a share
    group of Fourier signals, ``"chrom"`` or ``"ecorr"``; ``psd`` the
    compiled component kind of a GP; ``f``/``df`` its per-column
    frequencies and bin widths; ``params`` its PSD's parameters in the
    PSD's order (ECORR: one per backend, ``owners`` naming each
    column's)."""

    name: str
    group: str
    T: np.ndarray
    phi: float = 0.0
    psd: str = ""
    f: np.ndarray = None
    df: np.ndarray = None
    params: list = dataclasses.field(default_factory=list)
    owners: list = dataclasses.field(default_factory=list)


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


def _timing_basis(M, tm_svd, tm_norm):
    """The SVD of the column-normalized design matrix, the normalized
    matrix (``tm_norm``) or the matrix itself."""
    if not (tm_svd or tm_norm):
        return M.copy()
    Mn = M / np.linalg.norm(M, axis=0)
    return np.linalg.svd(Mn, full_matrices=False)[0] if tm_svd else Mn


def _amp_priors(upper_limit, upper_limit_red, upper_limit_common,
                upper_limit_dm):
    """``(red, common, dm, any)`` amplitude prior kinds of the factory:
    with no per-class flag every class follows ``upper_limit``; once one
    is given, each is LinearExp only under its own flag (``any``, the
    scattering GP's, always follows ``upper_limit``)."""
    glob = LINEAR_EXP if upper_limit else UNIFORM
    if (upper_limit_red is None and upper_limit_common is None
            and upper_limit_dm is None):
        return glob, glob, glob, glob
    return tuple(LINEAR_EXP if flag else UNIFORM for flag in (
        upper_limit_red, upper_limit_common, upper_limit_dm)) + (glob,)


def _gp(name, group, toas, ncomp, Tspan, psd, params, chrom=None,
        modes=None, wgts=None, shift=None, row_mask=None):
    """A Fourier-basis GP signal on the linear grid or on ``modes``;
    ``chrom = (radio_freqs, index)`` scales its rows by ``(1400 /
    nu)^index``, ``row_mask`` zeroes the rows outside it, ``shift`` (a
    ``pshift`` seed) adds random phases, and ``wgts`` replaces the bin
    widths by ``wgts^2``."""
    phases = None
    if shift is not None:
        phases = pshift_phases(shift, ncomp if modes is None else len(modes))
    F, f = fourier_basis(toas / DAY, ncomp, Tspan, modes=modes,
                         pshift_phases=phases)
    if chrom is not None:
        scale = (1400.0 / np.asarray(chrom[0])) ** float(chrom[1])
        F = F * scale[:, None]
    if row_mask is not None:
        F = F * np.asarray(row_mask, dtype=float)[:, None]
    df = (_bin_widths(f) if wgts is None
          else np.repeat(np.asarray(wgts, dtype=np.float64) ** 2, 2))
    return _Signal(name, group, F, psd=psd, f=f, df=df, params=params)


def _powerlaw_params(stem, psd, amp_kind, amp_bounds, log10_A=None,
                     gamma=None):
    """``[log10_A, gamma, shape constants...]`` of a powerlaw-family PSD:
    a sampled amplitude (or the constant ``log10_A``), a U(0, 7) index
    (or the constant ``gamma``), and ``psd``'s shape constants."""
    ps = [_Fixed(f"{stem}_log10_A", log10_A) if log10_A is not None
          else _Par(f"{stem}_log10_A", None, amp_kind, *amp_bounds),
          _Fixed(f"{stem}_gamma", gamma) if gamma is not None
          else _Par(f"{stem}_gamma", None, UNIFORM, 0.0, 7.0)]
    for hyper in PSD_HYPERS[psd][2:]:
        ps.append(_Fixed(f"{stem}_{hyper}", PSD_SHAPE_DEFAULTS[psd][hyper]))
    return ps


def _white(p, labels, white_vary, noisedict, gequad):
    """``(efac, equad, ecorr, gequad)`` parameters of one pulsar's white
    noise, the first three by backend label."""
    nd = noisedict or {}
    efac, equad, ecorr = {}, {}, {}
    for lab in labels:
        stem = f"{p.name}_{lab}" if lab else p.name
        names = (f"{stem}_efac", f"{stem}_log10_tnequad",
                 f"{stem}_log10_ecorr")
        if white_vary:
            efac[lab] = _Par(names[0], None, UNIFORM, 0.01, 10.0)
            equad[lab] = _Par(names[1], None, UNIFORM, -8.5, -5.0)
            ecorr[lab] = _Par(names[2], None, UNIFORM, -8.5, -5.0)
        else:
            efac[lab] = _Fixed(names[0], nd.get(names[0], 1.0))
            equad[lab] = _Fixed(names[1], nd.get(names[1], -40.0))
            ecorr[lab] = _Fixed(names[2], nd.get(names[2], -40.0))
    geq = None
    if gequad:
        gname = f"{p.name}_log10_gequad"
        geq = (_Par(gname, None, UNIFORM, -8.5, -5.0) if white_vary
               else _Fixed(gname, nd.get(gname, -40.0)))
    return efac, equad, ecorr, geq


def _red_params(o, rname):
    """``(psd, params)`` of an intrinsic red-noise signal named
    ``rname``."""
    red_psd = o["red_psd"]
    if red_psd == "spectrum":
        return "free_spectrum", [_Par(f"{rname}_log10_rho",
                                      o["red_components"], UNIFORM, -10.0,
                                      -4.0)]
    if red_psd == "infinitepower":
        return "infinitepower", []
    ps = _powerlaw_params(rname, "powerlaw", o["amp"][0], (-20.0, -11.0))
    if red_psd == "tprocess":
        # per-frequency InvGamma(df/2, df/2) scale factors, df = 2
        return "tprocess", ps + [_Par(f"{rname}_alphas", o["red_components"],
                                      INV_GAMMA, 1.0, 1.0)]
    if o["red_breakflat"]:
        return "powerlaw_breakflat", ps + [_Fixed(
            f"{rname}_log10_fb", np.log10(o["red_breakflat_fq"]))]
    return "powerlaw", ps


def _pulsar_model(p, o, Tspan, common):
    """One pulsar's signals in ``model_general``'s order and its white
    noise: ``(signals, labels, masks, (efac, equad, ecorr, gequad))``.
    The common process and unsplit red noise carry the pulsar's
    ``pshift`` phases (they share columns, so their shifts agree); a
    ``red_select`` group is a row-masked GP on columns of its own."""
    toas = p.toas
    grid, wgts = o["grid"], o["wgts"]
    shift = pshift_seed(o["pseed"], p.name) if o["pshift"] else None
    sigs = [_Signal("linear_timing_model", "static",
                    _timing_basis(p.Mmat, o["tm_svd"], o["tm_norm"]),
                    phi=1e40)]
    orf, gname = o["orf"], o["gname"]
    sigs.append(_gp(gname, "fourier" if orf == "crn" else gname, toas,
                    o["common_components"], Tspan, *common, modes=grid,
                    wgts=wgts, shift=shift))
    if o["red_var"]:
        if o["red_select"] is None:
            rname = f"{p.name}_red_noise"
            sigs.append(_gp(rname, "fourier", toas, o["red_components"],
                            Tspan, *_red_params(o, rname), modes=grid,
                            wgts=wgts, shift=shift))
        else:
            if o["red_select"] in BANDS:
                groups = {lab: (p.freqs > lo) & (p.freqs <= hi)
                          for lab, lo, hi in BANDS[o["red_select"]]}
            else:
                groups = _selection("backend", p.backend_flags)
            for lab in sorted(groups):
                mask = np.asarray(groups[lab], dtype=bool)
                if not mask.any():
                    continue
                rname = f"{p.name}_red_noise_{lab}"
                sigs.append(_gp(rname, "chrom", toas, o["red_components"],
                                Tspan, *_red_params(o, rname),
                                modes=grid, wgts=wgts, row_mask=mask))
    for on, suffix, psd, index, amp in (
            (o["dm_var"], "dm_gp", o["dm_psd"], 2.0, o["amp"][2]),
            (o["dm_chrom"], "chrom_gp", o["dmchrom_psd"], o["dmchrom_idx"],
             o["amp"][3])):
        if on:
            cname = f"{p.name}_{suffix}"
            sigs.append(_gp(cname, "chrom", toas, o["dm_components"], Tspan,
                            psd, _powerlaw_params(cname, psd, amp,
                                                  (-20.0, -11.0)),
                            chrom=(p.freqs, index), modes=grid))
    if o["dm_annual"]:
        w = 2.0 * np.pi / YEAR
        scale = (1400.0 / np.asarray(p.freqs)) ** 2
        sigs.append(_Signal("dm_annual", "static", np.column_stack(
            [np.sin(w * toas), np.cos(w * toas)]) * scale[:, None],
            phi=1e40))
    if o["bayesephem"]:
        sigs.append(_Signal("bayesephem", "static", bayesephem_basis(
            toas, p.pos, be_type=o["be_type"]), phi=1.0))
    masks = _selection(o["select"], p.backend_flags)
    labels = sorted(masks)
    white = _white(p, labels, o["white_vary"], o["noisedict"], o["gequad"])
    if _has_ecorr(p, o["is_wideband"]):
        U, owners = _ecorr_basis(toas, labels, masks)
        sigs.append(_Signal("basis_ecorr", "ecorr", U,
                            params=[white[2][lab] for lab in labels],
                            owners=owners))
    return sigs, labels, masks, white


def _layout(sigs):
    """``(ordered, slices, T)``: the signals in basis order (static,
    Fourier share groups with the widest member donating, chromatic,
    ECORR), each one's column slice, and the stacked basis."""
    static = [s for s in sigs if s.group == "static"]
    fourier = [s for s in sigs if s.group not in ("static", "chrom",
                                                  "ecorr")]
    rest = [s for s in sigs if s.group in ("chrom", "ecorr")]
    blocks, slices, off = [], {}, 0
    for s in static:
        blocks.append(s.T)
        slices[s.name] = slice(off, off + s.T.shape[1])
        off += s.T.shape[1]
    groups = {}
    for s in fourier:
        groups.setdefault(s.group, []).append(s)
    for members in groups.values():
        widths = [s.T.shape[1] for s in members]
        blocks.append(members[int(np.argmax(widths))].T)
        for s in members:
            slices[s.name] = slice(off, off + s.T.shape[1])
        off += max(widths)
    for s in rest:
        blocks.append(s.T)
        slices[s.name] = slice(off, off + s.T.shape[1])
        off += s.T.shape[1]
    return static + fourier + rest, slices, np.hstack(blocks)


def _refuse(o):
    """What ``model_general`` and ``compile_pta`` refuse, with the JAX
    package's messages, and several common processes, which the JAX
    compiled model takes but does not sample."""
    if o["tm_var"] or o["tm_linear"] or o["tmparam_list"] is not None:
        raise NotImplementedError(
            "tm_var/tm_linear: the reference's committed model_general "
            "never assigns a timing-model signal when tm_var=True "
            "(model_definition.py:185-190, NameError at PTA assembly), so "
            "there is no working behavior to match; the linear timing "
            "model here is always marginalized exactly in the b-draw")
    if o["use_dmdata"]:
        raise NotImplementedError(
            "use_dmdata requires wideband DM measurements "
            "(WidebandTimingModel); the par/tim ingestion layer models "
            "narrowband TOAs only")
    if o["dm_type"] != "gp":
        raise NotImplementedError(
            f"dm_type={o['dm_type']!r}: only the Gaussian-process DM model "
            "is implemented (the reference's other choices route through "
            "additional enterprise options it never exercises)")
    if o["red_psd"] == "tprocess_adapt":
        raise NotImplementedError(
            "red_psd='tprocess_adapt' (single adaptively-located alpha) is "
            "not implemented; red_psd='tprocess' gives the full "
            "per-frequency t-process with exact conjugate alpha draws")
    if o["red_breakflat"] and o["red_breakflat_fq"] is None:
        raise ValueError("red_breakflat=True requires red_breakflat_fq [Hz]")
    orfs = set(o["orf"].split(","))
    if len(orfs) > 1 and orfs - {"crn"}:
        raise NotImplementedError(f"mixed common-process ORFs {orfs}")
    if "," in o["orf"]:
        raise NotImplementedError(
            f"orf={o['orf']!r}: several common processes are not sampled. "
            "The JAX package's compiled model builds them all but samples "
            "only the first: its rho block, rho_ix_x and b-draw metadata "
            "take the first 'gw' signal, so the others' log10_rho never "
            "move. Model one common process")
    if o["common_psd"] not in ("spectrum",) + tuple(PSD_HYPERS):
        raise NotImplementedError(f"common_psd='{o['common_psd']}'")
    if o["red_var"]:
        red_psd = o["red_psd"]
        if o["red_breakflat"] and red_psd != "powerlaw":
            raise NotImplementedError(
                "red_breakflat applies to red_psd='powerlaw'")
        if o["red_select"] is not None and red_psd not in PSD_HYPERS:
            raise NotImplementedError(
                "red_select requires a powerlaw-family red_psd (split "
                "free-spectrum blocks have no conditional sampler)")
        if o["red_select"] not in (None, "backend") + tuple(BANDS):
            raise NotImplementedError(f"red_select={o['red_select']!r}")
        if red_psd not in ("spectrum", "tprocess", "infinitepower") and (
                red_psd not in PSD_HYPERS or PSD_HYPERS[red_psd][2:]):
            raise NotImplementedError(f"red_psd='{red_psd}'")
    for on, suffix, psd in ((o["dm_var"], "dm_gp", o["dm_psd"]),
                            (o["dm_chrom"], "chrom_gp", o["dmchrom_psd"])):
        if on and psd not in PSD_HYPERS:
            raise NotImplementedError(
                f"{suffix} psd='{psd}': chromatic GPs support the "
                "powerlaw-family PSDs (their amplitude/index hypers "
                "join the adaptive MH block; a free-spectrum chromatic "
                "block has no conditional sampler)")
    if o["orf"] != "crn":
        _refuse_orf(o["orf"], o["common_psd"])


#: model_arrays' options and their defaults (the array model of the
#: repository's tests; :func:`model_general` passes its own)
_DEFAULTS = dict(
    tm_var=False, tm_linear=False, tmparam_list=None, tm_svd=False,
    tm_norm=True, noisedict=None, white_vary=True, Tspan=None, modes=None,
    wgts=None, logfreq=False, nmodes_log=10, common_psd="spectrum",
    common_components=30, log10_A_common=None, gamma_common=None,
    common_logmin=None, common_logmax=None, orf="crn", orf_names=None,
    orf_ifreq=0, leg_lmax=5, upper_limit_common=None, upper_limit=False,
    red_var=True, red_psd="spectrum", red_components=30,
    upper_limit_red=None, red_select=None, red_breakflat=False,
    red_breakflat_fq=None, bayesephem=False, be_type="setIII_1980",
    is_wideband=False, use_dmdata=False, dm_var=False, dm_type="gp",
    dm_psd="powerlaw", dm_components=30, upper_limit_dm=None,
    dm_annual=False, dm_chrom=False, dmchrom_psd="powerlaw", dmchrom_idx=4,
    gequad=False, coefficients=False, pshift=False, pseed=None,
    select="backend", tm_marg=False, dense_like=False)


def model_arrays(psrs, *, pad_pulsars=None, kernel_ecorr=False,
                 pad_toas=None, pad_basis=None, **opts) -> dict:
    """The compiled model's fields as numpy arrays, named as the JAX
    ``CompiledPTA`` names them (the input of
    :func:`~..sampler.compiled.from_arrays`), for ``model_general``'s
    options ``opts`` (defaults: :data:`_DEFAULTS`, which vary the white
    noise and take free spectra), plus ``b_names``, the flat b columns'
    names, and ``host``, each real pulsar's basis (``T``, without the
    ECORR columns under ``kernel_ecorr``), residuals ``y``, TOA
    variances ``sigma2`` and unclipped ``phi_base`` in float64 for the
    host oracle.  ``kernel_ecorr`` is ``compile_pta``'s option of that name:
    the ECORR columns leave T and the epochs go into ``ke_eid`` (each
    TOA's epoch, ``Emax`` outside every epoch and on pads) and
    ``ke_par_ix`` (each epoch's log10_ecorr, the -40 constant on dummy
    epochs).  ``pad_pulsars``, ``pad_toas`` and ``pad_basis`` are
    ``compile_pta``'s: they force the pulsar axis ``P``, the TOA axis
    ``Nmax`` and the basis axis ``Bmax`` to at least the data's (smaller
    raise ``ValueError``).  Pad TOA rows carry ``y = 0``, ``T = 0``,
    ``sigma2 = 1``, constant EFAC 1 and EQUAD -40 (``N = 1``, no
    likelihood), pad basis columns ``phi_base = 1`` and ``basis_mask =
    0``, pad pulsars nothing: a dataset padded to a larger shape samples
    the same posterior.  The arrays take ``compile_pta``'s dtypes from
    the environment, read here (:func:`..config.current_settings`):
    storage ``dtype`` float64 under ``PTGIBBS_PRECISION=f64``, compute
    ``cdtype`` float64 unless ``PTGIBBS_COMPUTE=f32``.  Unknown options
    raise ``TypeError``; what the port does not take,
    ``NotImplementedError``."""
    unknown = set(opts) - set(_DEFAULTS)
    if unknown:
        raise TypeError(
            f"unknown model_general option(s): {sorted(unknown)}")
    o = dict(_DEFAULTS, **opts)
    _refuse(o)
    psrs = list(psrs)
    Tspan = get_tspan(psrs) if o["Tspan"] is None else o["Tspan"]
    o["grid"] = (log_grid(o["common_components"], o["nmodes_log"], Tspan)
                 if o["logfreq"] else o["modes"])
    P_real = len(psrs)
    P = pad_pulsars or P_real
    if P < P_real:
        raise ValueError("pad_pulsars smaller than the pulsar count")
    o["amp"] = _amp_priors(o["upper_limit"], o["upper_limit_red"],
                           o["upper_limit_common"], o["upper_limit_dm"])
    corr = o["orf"] != "crn"
    gname = o["gname"] = f"gw_{(o['orf_names'] or o['orf']).split(',')[0]}"
    if o["common_psd"] == "spectrum":
        lo = -10.0 if o["common_logmin"] is None else o["common_logmin"]
        hi = -4.0 if o["common_logmax"] is None else o["common_logmax"]
        common = ("free_spectrum", [_Par(f"{gname}_log10_rho",
                                        o["common_components"], UNIFORM,
                                        lo, hi)])
    else:
        lo = -18.0 if o["common_logmin"] is None else o["common_logmin"]
        hi = -11.0 if o["common_logmax"] is None else o["common_logmax"]
        common = (o["common_psd"], _powerlaw_params(
            gname, o["common_psd"], o["amp"][1], (lo, hi),
            o["log10_A_common"], o["gamma_common"]))

    orf_pars = _orf_weights(o["orf"], gname, o["leg_lmax"])
    models = []
    for p in psrs:
        sigs, labels, masks, white = _pulsar_model(p, o, Tspan, common)
        ordered, slices, T = _layout(sigs)
        ec = [s for s in ordered if s.group == "ecorr"]
        if kernel_ecorr and ec:
            # the ECORR columns (the trailing block) live inside N
            T = T[:, :slices[ec[0].name].start]
        models.append(dict(p=p, sigs=ordered, slices=slices, T=T,
                           labels=labels, masks=masks, white=white, ec=ec))
    if kernel_ecorr and not any(m["ec"] for m in models):
        raise ValueError(
            "ecorrsample='kernel' requested but the model has no ECORR "
            "signal (build with white_vary=True on NANOGrav-flagged data)")

    # ---- parameters: the sampled ones, by name, sorted ------------------
    seen = {q.name: q for q in orf_pars}
    for m in models:
        efac, equad, _, geq = m["white"]
        every = [q for s in m["sigs"] for q in s.params] + [
            efac[lab] for lab in m["labels"]] + [
            equad[lab] for lab in m["labels"]] + [geq]
        for q in every:
            if isinstance(q, _Par):
                seen.setdefault(q.name, q)
    params = sorted(seen.values(), key=lambda q: q.name)
    names = []
    for q in params:
        names += ([f"{q.name}_{k}" for k in range(q.size)] if q.size
                  else [q.name])
    nx = len(names)
    pos = {nm: ii for ii, nm in enumerate(names)}
    sentinel = nx
    pool = []

    def ref(q, elem=None):
        """``xe`` index of a parameter (an element of a vector one), a
        constant's value appended to the pool."""
        if isinstance(q, _Fixed):
            pool.append(float(q.value))
            return nx + len(pool)
        return pos[q.name if elem is None else f"{q.name}_{elem}"]

    widths = tuple(int(m["T"].shape[1]) for m in models)
    Nmax = max(p.ntoa for p in psrs)
    Bmax = max(widths)
    if pad_toas is not None:
        if pad_toas < Nmax:
            raise ValueError(
                f"pad_toas={pad_toas} smaller than the largest TOA count "
                f"{Nmax}")
        Nmax = int(pad_toas)
    if pad_basis is not None:
        if pad_basis < Bmax:
            raise ValueError(
                f"pad_basis={pad_basis} smaller than the widest basis "
                f"{Bmax}")
        Bmax = int(pad_basis)
    efac1, equad_off = ref(_Fixed("", 1.0)), ref(_Fixed("", -40.0))

    st = current_settings()
    np_dtype = np.float64 if st.precision == "f64" else np.float32
    np_cdtype = np.float64 if st.compute_precision == "f64" else np_dtype
    i32 = np.int32
    y = np.zeros((P, Nmax), np_dtype)
    T = np.zeros((P, Nmax, Bmax), np_dtype)
    toa_mask = np.zeros((P, Nmax), np_dtype)
    basis_mask = np.zeros((P, Bmax), np_dtype)
    psr_mask = np.zeros(P, np_dtype)
    sigma2 = np.ones((P, Nmax), np_dtype)
    efac_ix = np.full((P, Nmax), efac1, np.int32)
    equad_ix = np.full((P, Nmax), equad_off, np.int32)
    gequad_ix = np.full((P, Nmax), equad_off, np.int32)
    phi_base = np.ones((P, Bmax), np_dtype)
    gp_mask = np.zeros((P, Bmax), np_dtype)
    for ii, m in enumerate(models):
        p, n, w = m["p"], m["p"].ntoa, widths[ii]
        efac, equad, _, geq = m["white"]
        for s in m["sigs"]:
            if s.group not in ("static", "ecorr"):
                gp_mask[ii, m["slices"][s.name]] = 1.0
        y[ii, :n] = p.residuals
        T[ii, :n, :w] = m["T"]
        toa_mask[ii, :n] = 1.0
        basis_mask[ii, :w] = 1.0
        psr_mask[ii] = 1.0
        sigma2[ii, :n] = p.toaerrs ** 2
        for lab in m["labels"]:
            where = np.where(m["masks"][lab])[0]
            efac_ix[ii, where] = ref(efac[lab])
            equad_ix[ii, where] = ref(equad[lab])
        if geq is not None:
            gequad_ix[ii, :n] = ref(geq)
        for s in m["sigs"]:
            if kernel_ecorr and s.group == "ecorr":
                continue
            sl = m["slices"][s.name]
            phi_base[ii, sl] = (np.clip(s.phi, PHI_FLOOR, BIG_PHI)
                                if s.group == "static" else 0.0)

    # ---- GP components: Fourier signals, chromatic, ECORR ---------------
    def of_group(m, pred):
        return [s for s in m["sigs"] if pred(s.group)]

    fourier = [of_group(m, lambda g: g not in ("static", "chrom", "ecorr"))
               for m in models]
    chrom = [of_group(m, lambda g: g == "chrom") for m in models]
    specs = []
    for c in range(len(fourier[0])):
        rows = []
        for m, sigs in zip(models, fourier):
            s = sigs[c]
            sl = m["slices"][s.name]
            cols = np.arange(sl.start, sl.stop)
            if s.psd == "free_spectrum":
                hyp, rho = [], [ref(s.params[0], j // 2)
                                for j in range(len(cols))]
            elif s.psd == "tprocess":
                hyp = [ref(q) for q in s.params[:2]]
                rho = [ref(s.params[2], j // 2) for j in range(len(cols))]
            else:
                hyp, rho = [ref(q) for q in s.params], []
            rows.append((cols, s.f, s.df, hyp, rho))
        specs.append((fourier[0][c].psd, rows))
    if len({len(c) for c in chrom}) > 1:
        raise ValueError("pulsars disagree on chromatic signal count; the "
                         "compiled batch requires a homogeneous model "
                         "(build with model_general)")
    for c in range(len(chrom[0])):
        rows = []
        for m, sigs in zip(models, chrom):
            s = sigs[c]
            sl = m["slices"][s.name]
            rows.append((np.arange(sl.start, sl.stop), s.f, s.df,
                         [ref(q) for q in s.params], []))
        specs.append((chrom[0][c].psd, rows))
    ec_rows = []
    for m in models:
        ec = [] if kernel_ecorr else m["ec"]
        if ec:
            s = ec[0]
            sl = m["slices"][s.name]
            by_lab = dict(zip(m["labels"], s.params))
            ec_rows.append((np.arange(sl.start, sl.stop),
                            [ref(by_lab[lab]) for lab in s.owners]))
        else:
            ec_rows.append((np.zeros(0, np.int64), []))
    ke_eid = ke_par_ix = None
    if kernel_ecorr:
        Emax = max(m["ec"][0].T.shape[1] if m["ec"] else 0 for m in models)
        ke_eid = np.full((P, Nmax), Emax, i32)
        ke_par_ix = np.full((P, max(Emax, 1)), equad_off, i32)
        for ii, m in enumerate(models):
            if not m["ec"]:
                continue
            s = m["ec"][0]
            by_lab = dict(zip(m["labels"], s.params))
            U = s.T
            ke_eid[ii, :U.shape[0]] = np.where(U.sum(axis=1) > 0,
                                               U.argmax(axis=1), Emax)
            for e, lab in enumerate(s.owners):
                ke_par_ix[ii, e] = ref(by_lab[lab])
    if any(len(r[0]) for r in ec_rows):
        specs.append(("ecorr", [(cols, np.zeros(len(cols)),
                                 np.zeros(len(cols)), [], refs)
                                for cols, refs in ec_rows]))

    def pad2(rows, fill, w=None):
        w = w if w is not None else max((len(r) for r in rows), default=0)
        out = np.full((P, w), fill)
        for ii, r in enumerate(rows):
            out[ii, :len(r)] = r
        return out

    comps = []
    for kind, rows in specs:
        W = max(len(r[0]) for r in rows)
        H = max((len(r[3]) for r in rows), default=0)
        comps.append(dict(
            kind=kind, cols=pad2([r[0] for r in rows], Bmax, W).astype(i32),
            f=pad2([r[1] for r in rows], 1.0, W).astype(np_dtype),
            df=pad2([r[2] for r in rows], 0.0, W).astype(np_dtype),
            hyp_ix=pad2([r[3] for r in rows], sentinel, H).astype(i32),
            rho_ix=pad2([r[4] for r in rows], sentinel, W).astype(i32)))

    # ---- common / red conditional metadata -------------------------------
    floor_ref = ref(_Fixed("", -15.0))
    gsig = [next(s for s in f if "gw" in s.name) for f in fourier]
    K = len(gsig[0].f) // 2
    gw_kind = gsig[0].psd
    gw_sin = np.zeros((P, K), i32)
    gw_cos = np.zeros((P, K), i32)
    gw_f = np.ones((P, K), np_dtype)
    gw_df = np.zeros((P, K), np_dtype)
    Hg = 0 if gw_kind == "free_spectrum" else len(gsig[0].params)
    gw_hyp = np.full((P, max(Hg, 1)), sentinel, i32)
    gw_rho = np.full((P, K), floor_ref, i32)
    for ii, (m, s) in enumerate(zip(models, gsig)):
        sl = m["slices"][s.name]
        cols = np.arange(sl.start, sl.stop)
        gw_sin[ii], gw_cos[ii] = cols[::2], cols[1::2]
        gw_f[ii], gw_df[ii] = s.f[::2], s.df[::2]
        if gw_kind == "free_spectrum":
            gw_rho[ii] = [ref(s.params[0], k) for k in range(K)]
        else:
            gw_hyp[ii, :Hg] = [ref(q) for q in s.params]
    rho_ix_x = (np.asarray([pos[f"{gname}_log10_rho_{k}"] for k in range(K)],
                           i32) if gw_kind == "free_spectrum"
                else np.zeros(0, i32))

    rsig = [next((s for s in f if "red" in s.name), None) for f in fourier]
    red_valid = np.zeros(P, np_dtype)
    red_kind = rsig[0].psd if rsig[0] is not None else ""
    Kr = len(rsig[0].f) // 2 if red_kind else 0
    Kr1 = max(Kr, 1)
    Hr = (2 if red_kind == "tprocess" else len(rsig[0].params)
          if red_kind not in ("", "free_spectrum") else 0)
    red_hyp = np.full((P, max(Hr, 1)), sentinel, i32)
    red_rho = np.full((P, Kr1), floor_ref if Kr else sentinel, i32)
    red_rho_x = np.full((P, Kr1), nx, i32)
    red_sin = np.zeros((P, Kr1), i32)
    red_cos = np.zeros((P, Kr1), i32)
    red_f = np.ones((P, Kr1), np_dtype)
    red_df = np.zeros((P, Kr1), np_dtype)
    red_shares_gw = True
    if red_kind:
        overlaps = []
        for ii, (m, s, g) in enumerate(zip(models, rsig, gsig)):
            red_valid[ii] = 1.0
            sl, gl = m["slices"][s.name], m["slices"][g.name]
            overlaps.append(sl.start < gl.stop and gl.start < sl.stop)
            cols = np.arange(sl.start, sl.stop)
            red_sin[ii], red_cos[ii] = cols[::2], cols[1::2]
            red_f[ii], red_df[ii] = s.f[::2], s.df[::2]
            if red_kind == "free_spectrum":
                red_rho[ii] = red_rho_x[ii] = [ref(s.params[0], k)
                                               for k in range(Kr)]
            elif red_kind == "tprocess":
                # hypers (log10_A, gamma); the alphas ride red_rho and
                # the conjugate draw writes back through red_rho_ix_x
                red_hyp[ii, :2] = [ref(q) for q in s.params[:2]]
                red_rho[ii] = red_rho_x[ii] = [ref(s.params[2], k)
                                               for k in range(Kr)]
            else:
                red_hyp[ii, :Hr] = [ref(q) for q in s.params]
        red_shares_gw = any(overlaps)

    We = max(len(r[0]) for r in ec_rows)
    ecols = pad2([r[0] for r in ec_rows], Bmax, We).astype(i32)
    erho = pad2([r[1] for r in ec_rows], sentinel, We).astype(i32)

    # ---- per-pulsar white / ECORR parameter tables -----------------------
    wrows, erows = [], []
    for m in models:
        efac, equad, ecorr, geq = m["white"]
        white = [efac[lab] for lab in m["labels"]] + [
            equad[lab] for lab in m["labels"]] + [geq]
        wrows.append(sorted({pos[q.name] for q in white
                             if isinstance(q, _Par)}))
        erows.append(sorted({pos[q.name] for s in m["ec"] for q in s.params
                             if isinstance(q, _Par)}))

    def table(rows):
        out = pad2(rows, nx, max(max(len(r) for r in rows), 1)).astype(i32)
        return out, np.asarray([len(r) for r in rows] + [0] * (P - P_real),
                               i32)

    white_par_ix, white_nper = table(wrows)
    ecorr_par_ix, ecorr_nper = table(erows)

    # ---- priors ------------------------------------------------------------
    pkind = np.zeros(nx, i32)
    pa = np.zeros(nx, np_dtype)
    pb = np.ones(nx, np_dtype)
    pinit = np.full(nx, np.nan)
    ct = 0
    for q in params:
        n = q.size or 1
        pkind[ct:ct + n] = q.kind
        pa[ct:ct + n], pb[ct:ct + n] = q.lo, q.hi
        if q.init is not None:
            pinit[ct:ct + n] = q.init
        ct += n
    # InvGamma alphas are never MH-proposed (conjugate draws); they keep
    # a nonzero scale all the same
    prop_scale = np.where((pkind == NORMAL) | (pkind == INV_GAMMA), pb,
                          0.1 * np.abs(pb - pa)).astype(np_dtype)

    def rho_bounds(frag):
        """Variance bounds of the first free spectrum named ``frag``."""
        q = next((q for q in params if "rho" in q.name and frag in q.name),
                 None)
        return None if q is None else (10.0 ** (2.0 * q.lo),
                                       10.0 ** (2.0 * q.hi))

    rho_lo, rho_hi = rho_bounds("gw") or (1e-20, 1e-8)
    red_lo, red_hi = rho_bounds("red") or (rho_lo, rho_hi)

    orf_Ginv = orf_B = orf_par_ix = None
    if orf_pars:
        # G(theta) = I + sum_j theta_j B_j, zero-padded so that pad
        # pulsars stay at the identity; theta gathered out of x
        B_real, _ = orf_param_basis(o["orf"], [p.pos for p in psrs],
                                    leg_lmax=o["leg_lmax"])
        orf_B = np.zeros((len(orf_pars), P, P))
        orf_B[:, :P_real, :P_real] = B_real
        orf_par_ix = np.asarray([pos[q.name] for q in orf_pars], i32)
    elif corr:
        orf_Ginv = np.tile(np.eye(P), (K, 1, 1))
        orf_Ginv[:, :P_real, :P_real] = orf_ginv_stack(
            o["orf"], [p.pos for p in psrs], K, orf_ifreq=o["orf_ifreq"])

    b_names = []
    for m in models:
        named = {}
        for s in m["sigs"]:
            if kernel_ecorr and s.group == "ecorr":
                continue
            sl = m["slices"][s.name]
            for j in range(sl.start, sl.stop):
                named.setdefault(j, f"{m['p'].name}_{s.name}_{j - sl.start}")
        b_names += [named[j] for j in sorted(named)]

    return dict(
        P=P, P_real=P_real, Nmax=Nmax, Bmax=Bmax, nx=nx, K=K, Kr=Kr,
        widths=widths, pulsars=tuple(p.name for p in psrs),
        param_names=tuple(names), dtype=np_dtype,
        cdtype=np_cdtype, y=y, T=T, toa_mask=toa_mask,
        basis_mask=basis_mask, psr_mask=psr_mask, sigma2=sigma2,
        efac_ix=efac_ix, equad_ix=equad_ix, gequad_ix=gequad_ix,
        const_pool=np.asarray(pool, np_dtype), phi_base=phi_base,
        components=comps, pkind=pkind, pa=pa, pb=pb, prop_scale=prop_scale,
        gw_sin_ix=gw_sin, gw_cos_ix=gw_cos, gw_f=gw_f, gw_df=gw_df,
        gw_kind=gw_kind, gw_hyp_ix=gw_hyp, gw_rho_ix=gw_rho,
        rho_ix_x=rho_ix_x, red_valid=red_valid, red_kind=red_kind,
        red_hyp_ix=red_hyp, red_rho_ix=red_rho, red_rho_ix_x=red_rho_x,
        red_sin_ix=red_sin, red_cos_ix=red_cos, ec_cols=ecols, ec_ix=erho,
        white_par_ix=white_par_ix, white_nper=white_nper,
        ecorr_par_ix=ecorr_par_ix, ecorr_nper=ecorr_nper,
        rhomin=rho_lo, rhomax=rho_hi, red_rhomin=red_lo, red_rhomax=red_hi,
        orf_name=o["orf"], orf_Ginv=orf_Ginv, gp_mask=gp_mask, red_f=red_f,
        red_df=red_df, orf_B=orf_B, orf_par_ix=orf_par_ix,
        pinit=pinit if np.isfinite(pinit).any() else None,
        red_shares_gw=red_shares_gw, ke_eid=ke_eid, ke_par_ix=ke_par_ix,
        b_names=tuple(b_names),
        host=dict(T=[np.asarray(m["T"], np.float64) for m in models],
                  y=[np.asarray(p.residuals, np.float64) for p in psrs],
                  sigma2=[np.asarray(p.toaerrs, np.float64) ** 2
                          for p in psrs],
                  phi_base=[_static_phi(m) for m in models]))


def _static_phi(m):
    """One pulsar's float64 ``phi_base`` before the compiled model's
    clip: the static columns' prior variances, 0 on the GP columns."""
    out = np.zeros(m["T"].shape[1])
    for s in m["sigs"]:
        if s.group == "static":
            out[m["slices"][s.name]] = s.phi
    return out


def _refuse_orf(orf, common_psd):
    """What ``compile_pta`` refuses of a correlated ORF, with its
    messages."""
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


def crn_spectrum_arrays(psrs, nbins: int = 10, red_bins: int = 10,
                        pad_pulsars: int | None = None,
                        pad_toas: int | None = None,
                        pad_basis: int | None = None) -> dict:
    """The arrays of the repository's headline model: SVD timing model,
    a common and a per-pulsar red free spectrum (``nbins`` /
    ``red_bins``), EFAC/EQUAD and, for NANOGrav-flagged pulsars, ECORR;
    padded as :func:`model_arrays` pads."""
    return model_arrays(psrs, tm_svd=True, common_components=nbins,
                        red_var=True, red_components=red_bins,
                        pad_pulsars=pad_pulsars, pad_toas=pad_toas,
                        pad_basis=pad_basis)


def build_crn_spectrum(psrs, nbins: int = 10, red_bins: int = 10,
                       pad_pulsars: int | None = None, device=None):
    """The compiled model of :func:`crn_spectrum_arrays` on ``device``
    (``cuda`` unless the caller passes another)."""
    return from_arrays(crn_spectrum_arrays(psrs, nbins, red_bins,
                                           pad_pulsars), device=device)


def model_general(psrs, tm_svd=False, white_vary=False,
                  common_psd="powerlaw", common_components=30,
                  red_var=True, red_psd="powerlaw", red_components=30,
                  kernel_ecorr=False, device=None, **opts):
    """The compiled model of the JAX package's ``model_general(psrs,
    ...)`` followed by ``compile_pta``, on ``device`` (``cuda`` unless
    the caller passes another), with the JAX function's options and
    defaults (:data:`_DEFAULTS` lists the rest).

    The port takes: varied white noise, or fixed white noise from
    ``noisedict`` (``white_vary=False``; missing keys give EFAC 1 and
    EQUAD/ECORR off), ``gequad``; a common free spectrum
    (``common_logmin``/``common_logmax`` its log10_rho bounds) or a
    powerlaw-family common process (``powerlaw``, ``turnover``,
    ``turnover_knee``, ``broken_powerlaw``; ``log10_A_common`` /
    ``gamma_common`` fix its hypers, ``common_logmin``/``_logmax`` bound
    its amplitude); intrinsic red noise as a free spectrum, a powerlaw
    (``red_breakflat`` with ``red_breakflat_fq``: flat above the break),
    the t-process (``red_psd="tprocess"``: per-frequency InvGamma(1, 1)
    ``alphas`` scale the powerlaw) or ``infinitepower``;
    ``dm_var`` / ``dm_chrom`` chromatic GPs (``dm_psd``,
    ``dmchrom_psd``, ``dmchrom_idx``, ``dm_components``); ``dm_annual``;
    ``bayesephem`` / ``be_type``; the upper-limit flags (LinearExp
    amplitude priors); ``orf="crn"``, the fixed positive-definite
    ORFs (``hd``, ``freq_hd`` with ``orf_ifreq``, ``st``,
    ``gw_monopole``, ``gw_dipole``) and the ORFs with sampled
    correlation weights (``bin_orf``: 7 angular-separation bins;
    ``legendre_orf``: ``leg_lmax + 1`` Legendre coefficients; each a
    ``Uniform(-1, 1)`` ``<gw>_orfw_*`` parameter that an initial sample
    starts at 0, ``G = I``) under a common free spectrum;
    ``coefficients``, ``dense_like`` and ``tm_marg`` are accepted and
    dropped, as the JAX function drops them.  The frequency grid:
    ``Tspan`` (default the array's span), ``modes`` (explicit
    frequencies), ``logfreq`` with ``nmodes_log`` (:func:`log_grid`),
    ``wgts`` (bin widths ``wgts^2``), ``pshift`` / ``pseed`` (per-pulsar
    random phases on the common and red columns); the selections:
    ``red_select`` (``"band"``, ``"band+"``, ``"backend"``: a row-masked
    powerlaw red GP per group, on columns of their own), ``select``
    (``"backend"``, or ``None`` / ``"none"`` for one white-noise group),
    ``tm_norm`` and ``orf_names`` (one common process).
    ``kernel_ecorr=True`` is ``compile_pta``'s option: ECORR inside N
    (Woodbury) in place of its basis columns, the model
    ``PulsarBlockGibbs`` / ``PTABlockGibbs(cm, ecorrsample="kernel")``
    sample; a model without ECORR is refused.  What the JAX functions
    refuse raises with their type and message; several common processes
    (``orf`` with a comma) raise ``NotImplementedError``, since the JAX
    compiled model builds them but samples only the first.  README's
    Quick start (with kernel ECORR), ``bench.py``'s Hellings-Downs array
    and the array with the standard noise model::

        model_general([psr], red_var=False, white_vary=True,
                      common_psd="spectrum", common_components=30,
                      kernel_ecorr=True)
        model_general(psrs, tm_svd=True, white_vary=True,
                      common_psd="spectrum", common_components=10,
                      red_psd="spectrum", red_components=10, orf="hd")
        model_general(psrs, tm_svd=True, noisedict=nd,
                      common_psd="spectrum", common_components=10,
                      red_components=10, dm_var=True, dm_components=10,
                      dm_annual=True)
    """
    return from_arrays(model_arrays(
        psrs, tm_svd=tm_svd, white_vary=white_vary, common_psd=common_psd,
        common_components=common_components, red_var=red_var,
        red_psd=red_psd, red_components=red_components,
        kernel_ecorr=kernel_ecorr, **opts), device=device)
