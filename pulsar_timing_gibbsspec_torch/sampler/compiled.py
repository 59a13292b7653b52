"""The compiled PTA model as tensors on one device.

Port of ``pulsar_timing_gibbsspec_tpu/sampler/compiled.py`` for the
models of ``models/build.py``: basis ECORR, or kernel ECORR (the epoch
blocks inside N: ``ke_eid``, ``ke_par_ix``); a free-spectrum or
powerlaw-family common process (``powerlaw``, ``turnover``,
``turnover_knee``, ``broken_powerlaw``); free-spectrum, powerlaw,
flat-above-a-break (``powerlaw_breakflat``), t-process (a powerlaw
times per-frequency InvGamma alphas) or ``infinitepower`` (``BIG_PHI``)
intrinsic red noise;
chromatic GPs of the powerlaw family on columns of their own; static
marginalized columns (timing model, ``dm_annual``, BayesEphem) with a
constant ``phi_base``; and a common free spectrum under a correlated
ORF on columns of its own: a fixed one (Hellings-Downs and the others
of ``models/orf.py``: the static inverse ORF stack ``orf_Ginv``) or one
with sampled correlation weights (``bin_orf``, ``legendre_orf``: ``G =
I + sum_j theta_j B_j`` from ``orf_B`` and the weights ``x[orf_par_ix]``,
rebuilt per chain state).  Ragged per-pulsar shapes are padded to ``(P, Nmax)`` /
``(P, Bmax)``, every hyperparameter reference, sampled or constant, is
compiled to an integer gather into ``xe = [x, 0-sentinel, constants]``,
and ``phi(x)`` is a scatter-add of the per-component variances onto the
basis columns.

Every method broadcasts over leading batch dimensions of ``x`` / ``b``:
the driver carries the chains as a leading axis, ``x`` of shape
``(C, nx)`` and ``b`` of shape ``(C, P, Bmax)``, where the JAX package
vmaps a single-chain body.  A tenant stack (``tenants = T > 0``, built by
``serve.engine.stack_models``) holds T models of one shape signature:
each per-pulsar or per-coordinate tensor gains a leading tenant axis,
``(T, P, ...)`` / ``(T, nx)``, and row t of ``x`` (T, nx) / ``b`` (T, P,
Bmax) is tenant t's one chain.  Gathers into ``xe`` go through
:meth:`CompiledPTA.gx`, which pairs each row with its own indices.

Padding conventions are the JAX package's: TOA pads carry ``y=0, T=0,
sigma2=1, efac=1, equad=-40`` (``N = 1``), basis pads ``phi = 1``, and
scatter/gather pads point one past the end and are dropped.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import current_settings, resolve_device, settings

#: prior-variance stand-in for the marginalized timing-model columns
#: (the JAX package's ``BIG_PHI``, kept identical)
BIG_PHI = 1e30
#: floor where a process has no variance on a column (``PHI_FLOOR``)
PHI_FLOOR = 1e-30
#: powerlaw constants: ln 10, ln(12 pi^2), ln(1 / year)
_LN10 = math.log(10.0)
_LN12PI2 = math.log(12.0 * math.pi ** 2)
_LNFYR = math.log(1.0 / (365.25 * 86400.0))
#: the powerlaw-family PSDs the port evaluates from hyperparameters
POWERLAW_KINDS = ("powerlaw", "turnover", "turnover_knee",
                  "broken_powerlaw", "powerlaw_breakflat")

# Each PSD is evaluated in log space (``f**-gamma`` overflows float32)
# with every term rounded where the JAX package's ``_lnphi_*`` rounds it:
# ``f``/``df`` in the storage dtype and their logs taken there, sums and
# products of the hypers alone in the hypers' dtype (the dtype phi is
# asked in), every term that meets a float64 constant (``ln 10``, ``ln
# f_yr``, ``ln 12 pi^2``) in float64.

_F64 = torch.float64


def _softplus(z):
    return torch.logaddexp(torch.zeros_like(z), z)


def _lnhc_powerlaw(lnf, log10_A, gamma):
    """``ln A + (3 - gamma)/2 ln(f / f_yr)``, the characteristic strain's
    powerlaw part, float64."""
    return (_LN10 * log10_A.to(_F64)
            + (0.5 * (3.0 - gamma)).to(_F64) * (lnf.to(_F64) - _LNFYR))


def _lnphi_from_hc(lnhc, lnf, df):
    """``ln(hc^2 / (12 pi^2 f^3) df)`` from ``ln hc``."""
    return (2.0 * lnhc - _LN12PI2 - (3.0 * lnf).to(_F64)
            + torch.log(df).to(_F64))


def _lnphi_powerlaw(f, df, log10_A, gamma):
    """Log of the powerlaw prior variance per column."""
    return (2.0 * _LN10 * log10_A.to(_F64) - _LN12PI2
            + (gamma - 3.0).to(_F64) * _LNFYR
            - (gamma * torch.log(f)).to(_F64) + torch.log(df).to(_F64))


def _lnphi_turnover(f, df, log10_A, gamma, lf0, kappa):
    """Powerlaw with a low-frequency turnover at ``10^lf0`` (``beta =
    1/2``)."""
    lnf = torch.log(f)
    lnhc = (_lnhc_powerlaw(lnf, log10_A, gamma)
            - 0.5 * _softplus(kappa.to(_F64)
                              * (_LN10 * lf0.to(_F64) - lnf.to(_F64))))
    return _lnphi_from_hc(lnhc, lnf, df)


def _lnphi_broken_powerlaw(f, df, log10_A, gamma, delta, log10_fb, kappa):
    """Powerlaw of index ``gamma`` below ``10^log10_fb`` and ``delta``
    above it, with a transition of width ``kappa``."""
    lnf = torch.log(f)
    lnhc = (_lnhc_powerlaw(lnf, log10_A, gamma)
            + (0.5 * kappa * (gamma - delta)).to(_F64)
            * _softplus((lnf.to(_F64) - _LN10 * log10_fb.to(_F64))
                        / kappa.to(_F64)))
    return _lnphi_from_hc(lnhc, lnf, df)


def _lnphi_turnover_knee(f, df, log10_A, gamma, lfb, lfk, kappa, delta):
    """Turnover at ``10^lfb`` and a high-frequency knee at ``10^lfk``."""
    lnf = torch.log(f)
    lnhc = (_lnhc_powerlaw(lnf, log10_A, gamma)
            + _softplus(delta.to(_F64)
                        * (lnf.to(_F64) - _LN10 * lfk.to(_F64)))
            - 0.5 * _softplus(kappa.to(_F64)
                              * (_LN10 * lfb.to(_F64) - lnf.to(_F64))))
    return _lnphi_from_hc(lnhc, lnf, df)


def _lnphi_powerlaw_breakflat(f, df, log10_A, gamma, log10_fb):
    """Powerlaw held flat above the break ``10^log10_fb``."""
    lnf = torch.minimum(torch.log(f).to(_F64), _LN10 * log10_fb.to(_F64))
    return (2.0 * _LN10 * log10_A.to(_F64) - _LN12PI2
            + (gamma - 3.0).to(_F64) * _LNFYR
            - gamma.to(_F64) * lnf + torch.log(df).to(_F64))


#: log-PSD of each powerlaw-family kind, taking ``(f, df, *hypers)``
_LNPSD_FNS = {
    "powerlaw": _lnphi_powerlaw,
    "turnover": _lnphi_turnover,
    "turnover_knee": _lnphi_turnover_knee,
    "broken_powerlaw": _lnphi_broken_powerlaw,
    "powerlaw_breakflat": _lnphi_powerlaw_breakflat,
}


@dataclasses.dataclass
class BlockIndex:
    """Positions of each Gibbs block inside the flat chain vector,
    located by name fragment as the JAX package does."""

    names: list
    rho: np.ndarray          # common free-spectrum log10_rho entries
    red: np.ndarray          # powerlaw-family hypers (log10_A, gamma)
    red_rho: np.ndarray      # per-pulsar free-spectrum entries
    white: np.ndarray        # efac / equad entries
    ecorr: np.ndarray        # ecorr entries
    orf: np.ndarray          # sampled ORF weights ("_orfw_" fragment)

    @classmethod
    def build(cls, param_names) -> "BlockIndex":
        rho, red, red_rho, white, ecorr, orf = [], [], [], [], [], []
        for ii, nm in enumerate(param_names):
            if "rho" in nm and "gw" in nm:
                rho.append(ii)
            if "log10_A" in nm or "gamma" in nm:
                red.append(ii)
            if "rho" in nm and "red" in nm:
                red_rho.append(ii)
            if "efac" in nm or "equad" in nm:
                white.append(ii)
            if "ecorr" in nm:
                ecorr.append(ii)
            if "_orfw_" in nm:
                orf.append(ii)

        def arr(v):
            return np.asarray(v, dtype=np.int64)

        return cls(list(param_names), arr(rho), arr(red), arr(red_rho),
                   arr(white), arr(ecorr), arr(orf))


#: the prior classes of the JAX package, by ``pkind`` code
PRIOR_NAMES = ("Uniform", "Normal", "LinearExp", "InvGamma")


@dataclasses.dataclass(frozen=True)
class Param:
    """A sampled parameter: ``size`` entries (None: a scalar), its
    prior's class name and its two numbers (bounds; Normal's mean and
    deviation; InvGamma's shape and rate)."""

    name: str
    size: int | None
    prior: str
    a: float
    b: float


def params_of(names, kind, a, b):
    """The sampled parameters in chain order from the chain's names and
    per-coordinate priors (``kind``, ``a``, ``b``): a vector parameter
    is the run of names ``<name>_0 .. <name>_{n-1}`` under one prior,
    every other name a scalar (``size`` None); the sampled ORF weights
    (``<gw>_orfw_bin_<j>``, ``..._leg_<l>``) are scalars."""
    out, j, nx = [], 0, len(names)
    while j < nx:
        stem, _, k = names[j].rpartition("_")
        n = 1
        if "_orfw_" in stem:
            k = None
        if k == "0":
            while j + n < nx and names[j + n] == f"{stem}_{n}":
                n += 1
        vec = k == "0"
        out.append(Param(stem if vec else names[j], n if vec else None,
                         PRIOR_NAMES[int(kind[j])], float(a[j]),
                         float(b[j])))
        j += n
    return out


@dataclasses.dataclass
class GPComponent:
    """One Fourier-GP or basis-ECORR component, stacked over pulsars:
    ``cols`` index the basis axis (pad ``Bmax``, dropped on scatter).  A
    free spectrum (ECORR) gathers each column's log10_rho (log10_ecorr)
    out of ``xe`` through ``rho_ix``, the column's variance being
    ``10^(2 xe[rho_ix])``; a powerlaw-family PSD gathers its hypers
    (``log10_A``, ``gamma``, then its shape constants) through ``hyp_ix``
    and evaluates at the column's ``f`` and ``df``; the t-process is the
    powerlaw of ``hyp_ix`` times the alpha ``rho_ix`` gathers; and
    ``infinitepower`` is ``BIG_PHI`` on every column."""

    kind: str
    cols: torch.Tensor       # (P, W) int64
    rho_ix: torch.Tensor     # (P, W) int64
    f: torch.Tensor = None   # (P, W) storage dtype, per-column frequency
    df: torch.Tensor = None  # (P, W) per-column bin width
    hyp_ix: torch.Tensor = None  # (P, H) int64 -> xe


@dataclasses.dataclass
class CompiledPTA:
    """Static device model of a PTA."""

    P: int
    P_real: int
    Nmax: int
    Bmax: int
    nx: int
    K: int
    Kr: int
    param_names: tuple
    device: torch.device
    dtype: torch.dtype
    cdtype: torch.dtype
    y: torch.Tensor            # (P, Nmax) storage dtype
    T: torch.Tensor            # (P, Nmax, Bmax)
    toa_mask: torch.Tensor     # (P, Nmax)
    psr_mask: torch.Tensor     # (P,)
    sigma2: torch.Tensor       # (P, Nmax)
    efac_ix: torch.Tensor      # (P, Nmax) -> xe
    equad_ix: torch.Tensor     # (P, Nmax) -> xe
    gequad_ix: torch.Tensor    # (P, Nmax) -> xe
    const_pool: torch.Tensor   # (npool,)
    phi_base: torch.Tensor     # (P, Bmax)
    components: list
    pkind: torch.Tensor        # (nx,) 0 uniform / 1 normal / 2 linexp / 3 ig
    pa: torch.Tensor           # (nx,)
    pb: torch.Tensor           # (nx,)
    prop_scale: torch.Tensor   # (nx,)
    idx: BlockIndex
    gw_sin_ix: torch.Tensor    # (P, K) -> b columns
    gw_cos_ix: torch.Tensor    # (P, K)
    gw_f: torch.Tensor         # (P, K) per-frequency (storage dtype)
    gw_df: torch.Tensor        # (P, K) bin widths
    gw_kind: str
    gw_hyp_ix: torch.Tensor    # (P, Hg) -> xe (powerlaw-family hypers)
    gw_rho_ix: torch.Tensor    # (P, K) -> xe
    rho_ix_x: torch.Tensor     # (K,) -> x
    red_valid: torch.Tensor    # (P,)
    red_kind: str
    red_hyp_ix: torch.Tensor   # (P, Hr) -> xe (powerlaw-family hypers)
    red_rho_ix: torch.Tensor   # (P, Kr) -> xe
    red_rho_ix_x: torch.Tensor  # (P, Kr) -> x (pad nx: dropped)
    red_sin_ix: torch.Tensor   # (P, Kr)
    red_cos_ix: torch.Tensor   # (P, Kr)
    white_par_ix: torch.Tensor  # (P, Wp) -> x (pad nx)
    white_nper: torch.Tensor   # (P,)
    ec_cols: torch.Tensor      # (P, We) ECORR columns of b (pad Bmax)
    ec_ix: torch.Tensor        # (P, We) their log10_ecorr -> xe
    ecorr_par_ix: torch.Tensor  # (P, Ep) -> x (pad nx)
    ecorr_nper: torch.Tensor   # (P,)
    gp_mask: torch.Tensor      # (P, Bmax) 1.0 on the Fourier and
                               # chromatic GP columns
    rhomin: float
    rhomax: float
    red_rhomin: float
    red_rhomax: float
    red_shares_gw: bool = True
    orf_name: str = "crn"
    #: (K, P, P) float64 per-frequency inverse ORF stack of a fixed
    #: correlated common process (identity on pad pulsars); None for CRN
    #: and for sampled weights
    orf_Ginv: torch.Tensor = None
    #: sampled ORF weights: the (J, P, P) float64 basis of ``G(theta) =
    #: I + sum_j theta_j B_j`` (zero on pad pulsars) and the weights'
    #: positions in x (J,); None for a fixed ORF
    orf_B: torch.Tensor = None
    orf_par_ix: torch.Tensor = None
    #: (nx,) float64 start of each coordinate in an initial sample, NaN
    #: where it is a prior draw (the sampled ORF weights start at 0);
    #: None when every coordinate is drawn
    pinit: torch.Tensor = None
    #: true basis width per real pulsar
    widths: tuple = ()
    #: pulsar names in logical order (empty when the arrays carry none)
    pulsars: tuple = ()
    #: the flat b columns' names where the model builder gives them
    #: (empty: :meth:`b_param_names` derives them from the components)
    b_names: tuple = ()
    #: (P, Kr) red-grid frequencies and bin widths (storage dtype; the
    #: t-process alpha draw evaluates the powerlaw there)
    red_f: torch.Tensor = None
    red_df: torch.Tensor = None
    #: kernel ECORR (``ecorrsample="kernel"``): the epoch blocks live in
    #: N, ``N = D + U c U^T`` with disjoint epoch indicators U, in place
    #: of basis columns.  ``ke_eid`` (P, Nmax) is each TOA's epoch
    #: (``Emax``: outside every epoch, and pads), ``ke_par_ix`` (P, Emax)
    #: each epoch's log10_ecorr gather into ``xe`` (dummy epochs: the -40
    #: constant), ``ke_U`` (P, Emax, Nmax) the indicators U^T in the
    #: compute dtype, whose products are the epoch sums.  None when off
    ke_eid: torch.Tensor = None
    ke_par_ix: torch.Tensor = None
    ke_U: torch.Tensor = None
    #: the length of the leading tenant axis of a tenant stack, 0 for one
    #: model
    tenants: int = 0
    #: TOA-segment lengths of the segmented Grams (steady and refresh /
    #: exact), the settings' when the model was built
    gram_seg_len: int = 96
    gram_seg_len_exact: int = 96
    #: the arrays the model was built from (:func:`from_arrays`'s
    #: ``fields``, numpy on the host), which the NumPy oracle reads
    #: through :class:`.host_model.HostPTA`; None when not kept
    arrays: dict = dataclasses.field(default=None, repr=False)
    #: ``idx.red`` and ``idx.orf`` on the device: the powerlaw hypers'
    #: and the sampled ORF weights' positions in x (a block that runs in
    #: a CUDA graph copies nothing from the host)
    red_ix: torch.Tensor = dataclasses.field(init=False)
    orf_ix: torch.Tensor = dataclasses.field(init=False)
    #: a shard of a mesh (:func:`..parallel.sharding.shard_compiled`):
    #: the per-pulsar tensors hold the rows ``[p0, p0 + pn)`` of the
    #: logical padded width ``P`` (``P_real``, ``widths`` and ``pulsars``
    #: stay logical), and ``shard`` carries the mesh; one model holds
    #: every row (``p0`` 0, ``pn`` ``P``, ``shard`` None)
    p0: int = 0
    pn: int = 0
    shard: object = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if not self.pn:
            self.pn = self.P
        self.red_ix = torch.as_tensor(self.idx.red, dtype=torch.int64,
                                      device=self.device)
        self.orf_ix = torch.as_tensor(self.idx.orf, dtype=torch.int64,
                                      device=self.device)

    @property
    def has_ke(self) -> bool:
        """True when the model compiles ECORR into N (kernel ECORR)."""
        return self.ke_eid is not None

    # ---- names ------------------------------------------------------------

    def params(self):
        """The sampled parameters in chain order (the JAX model's
        ``params``): :func:`params_of` of the model's names and priors."""
        return params_of(self.param_names, *(v.cpu().numpy() for v in
                                              (self.pkind, self.pa,
                                               self.pb)))

    def map_params(self, xs):
        """``{name: value}`` of one chain vector ``xs`` (nx,): a float per
        scalar (and per vector of one entry), an array per vector."""
        xs = np.asarray(xs.cpu() if torch.is_tensor(xs) else xs)
        ret, ct = {}, 0
        for q in self.params():
            n = q.size or 1
            ret[q.name] = (np.asarray(xs[ct:ct + n]) if n > 1
                           else float(xs[ct]))
            ct += n
        return ret

    def b_param_names(self):
        """Names of the flat b columns, the JAX facade's
        ``b_param_names``: those of the model builder (:attr:`b_names`)
        where it gave them, else, for a model of timing-model, Fourier
        and ECORR columns alone: per real pulsar,
        ``<pulsar>_<signal>_<j>`` for its timing-model columns
        (``linear_timing_model``), then each
        Fourier column named after the first signal holding it, in the
        model's signal order (the common process before intrinsic red),
        then the ECORR columns (``<pulsar>_basis_ecorr_<j>``).  A
        Fourier signal's name is its parameters' stem (``gw_crn``,
        ``<pulsar>_red_noise``)."""
        if self.b_names:
            return list(self.b_names)
        if len(self.pulsars) != self.P_real:
            raise ValueError("the model carries no pulsar names; build it "
                             "with build_crn_spectrum or pass 'pulsars' "
                             "to from_arrays")
        def stem(c, p, live):
            """The signal name of component ``c`` on pulsar ``p``."""
            if c.kind == "ecorr":
                return "basis_ecorr"
            if c.kind == "free_spectrum":
                nm = self.param_names[int(c.rho_ix[p][live][0])]
                return nm.rsplit("_log10_rho_", 1)[0]
            return self.param_names[int(c.hyp_ix[p][0])].rsplit(
                "_log10_A", 1)[0]

        comps = [(c.cols.cpu().numpy(), c) for c in self.components]
        out = []
        for p, (psr, width) in enumerate(zip(self.pulsars, self.widths)):
            gp = {int(j) for cols, _ in comps for j in cols[p]
                  if j < self.Bmax}
            ntm = width - len(gp)
            named = {j: f"{psr}_linear_timing_model_{j}"
                     for j in range(ntm)}
            for cols, c in comps:
                live = cols[p] < self.Bmax
                if not live.any():
                    continue
                sig = stem(c, p, torch.as_tensor(live, device=c.cols.device))
                start = int(cols[p][live].min())
                for j in cols[p][live]:
                    named.setdefault(int(j), f"{psr}_{sig}_{j - start}")
            out += [named[j] for j in sorted(named)]
        return out

    # ---- gathers ----------------------------------------------------------

    def xe(self, x):
        """``[x, 0, const_pool]`` in the compute dtype, (..., nx+1+npool)."""
        x = x.to(self.cdtype)
        lead = x.shape[:-1]
        return torch.cat([
            x, x.new_zeros(lead + (1,)),
            self.const_pool.to(self.cdtype).expand(
                lead + self.const_pool.shape[-1:])], dim=-1)

    def gx(self, xev, ix):
        """``xev[..., ix]``, the gather of the index table ``ix`` into
        ``xe``.  On a tenant stack ``ix`` leads with the tenant axis and
        ``xev`` (..., T, nxe) row t is gathered through ``ix[t]``."""
        if not self.tenants:
            return xev[..., ix]
        lead = xev.shape[:-1]
        flat = ix.reshape(ix.shape[0], -1).expand(lead + (-1,))
        return torch.gather(xev, -1, flat).reshape(lead + ix.shape[1:])

    def _ndiag_from(self, xev):
        efac = self.gx(xev, self.efac_ix)
        equad = self.gx(xev, self.equad_ix)
        gequad = self.gx(xev, self.gequad_ix)
        return (efac * efac * self.sigma2 + torch.pow(10.0, 2.0 * equad)
                + torch.pow(10.0, 2.0 * gequad))

    def ndiag(self, x):
        """(..., P, Nmax) diagonal measurement covariance (compute dtype)."""
        return self._ndiag_from(self.xe(x))

    def ndiag_fast(self, x):
        """(..., P, Nmax) measurement covariance in the storage dtype."""
        return self._ndiag_from(self.xe(x).to(self.dtype))

    def _psd(self, kind, xev, f, df, hyp_ix):
        """Powerlaw-family variances ``(..., P, W)`` (float64) of PSD
        ``kind`` at ``f``/``df`` (P, W), with its ``H`` hypers gathered
        out of ``xev`` through ``hyp_ix`` (P, H): sampled ones from
        ``x``, constant ones from the pool."""
        args = [self.gx(xev, hyp_ix[..., h])[..., None]
                for h in range(hyp_ix.shape[-1])]
        return torch.exp(_LNPSD_FNS[kind](f, df, *args))

    def _phi_accum(self, x, base, comps, dtype=None):
        """Scatter-add the components' variances onto ``base`` (P, Bmax)
        or (..., P, Bmax); columns at index ``Bmax`` (pads) are
        dropped."""
        dtype = dtype or self.cdtype
        xev = self.xe(x).to(dtype)
        lead = xev.shape[:-1]
        B = self.Bmax
        phi = torch.cat([
            torch.broadcast_to(base.to(dtype), lead + (self.pn, B)),
            xev.new_zeros(lead + (self.pn, 1))], dim=-1)
        for c in comps:
            shape = lead + c.cols.shape[-2:]
            if c.kind in ("free_spectrum", "ecorr"):
                vals = torch.pow(10.0, 2.0 * self.gx(xev, c.rho_ix))
            elif c.kind == "infinitepower":
                vals = torch.full(shape, BIG_PHI, dtype=dtype,
                                  device=self.device)
            elif c.kind == "tprocess":
                vals = (self._psd("powerlaw", xev, c.f, c.df, c.hyp_ix)
                        * self.gx(xev, c.rho_ix))
            else:
                vals = self._psd(c.kind, xev, c.f, c.df, c.hyp_ix)
            phi = phi.scatter_add(-1, c.cols.expand(shape), vals.to(dtype))
        return phi[..., :B]

    def phi(self, x, dtype=None):
        """(..., P, Bmax) per-column prior variance (pads = 1), floored
        at PHI_FLOOR (a powerlaw at a prior corner can underflow)."""
        phi = self._phi_accum(x, self.phi_base, self.components, dtype)
        return torch.clamp(phi, min=PHI_FLOOR)

    def phi_hyper_split(self, x, dtype=None):
        """``(static, dyn)``: the part of phi that stays constant while
        only the powerlaw hypers move (free spectra and ECORR, whose
        parameters belong to other blocks), evaluated once at ``x``, and
        a function ``q -> phi(q)`` adding the powerlaw components to it
        (floored as :meth:`phi`)."""
        stat = [c for c in self.components
                if c.kind in ("free_spectrum", "ecorr")]
        dyn_comps = [c for c in self.components
                     if c.kind not in ("free_spectrum", "ecorr")]
        static = self._phi_accum(x, self.phi_base, stat, dtype)

        def dyn(q):
            return torch.clamp(self._phi_accum(q, static, dyn_comps, dtype),
                               min=PHI_FLOOR)

        return static, dyn

    # ---- priors -------------------------------------------------------------

    @staticmethod
    def _logpdf(kind, a, b_, v):
        ninf = torch.full_like(v, -math.inf)
        inside = (v >= a) & (v <= b_)
        lp_u = torch.where(inside, -torch.log(b_ - a), ninf)
        lp_n = (-0.5 * ((v - a) / b_) ** 2
                - torch.log(b_ * math.sqrt(2.0 * math.pi)))
        dens = (math.log(10.0) * torch.pow(10.0, v)
                / (torch.pow(10.0, b_) - torch.pow(10.0, a)))
        lp_l = torch.where(inside, torch.log(dens), ninf)
        vp = torch.clamp(v, min=1e-30)
        lp_g = torch.where(
            v > 0, a * torch.log(b_) - torch.lgamma(a)
            - (a + 1.0) * torch.log(vp) - b_ / vp, ninf)
        return torch.where(kind == 0, lp_u,
                           torch.where(kind == 1, lp_n,
                                       torch.where(kind == 2, lp_l, lp_g)))

    def lnprior(self, x):
        """(...,) joint prior log-density of ``x`` (..., nx)."""
        # the bounds stay in their storage dtype, as in the JAX package
        # (whose prior constants are numpy float32 arithmetic)
        return self._logpdf(self.pkind, self.pa, self.pb,
                            x.to(self.cdtype)).sum(-1)

    def coord_logpdf(self, j, v):
        """Prior log-density of value ``v`` for coordinate ``j`` (index
        tensor broadcasting against ``v``), in ``v``'s dtype."""
        j = torch.clamp(j, max=self.nx - 1)
        dt = v.dtype
        return self._logpdf(self.pkind[j], self.pa.to(dt)[j],
                            self.pb.to(dt)[j], v)

    # ---- correlated common process -----------------------------------------

    def orf_G(self, x):
        """(..., P, P) ORF correlation matrix of sampled weights at the
        states ``x`` (..., nx), compute dtype."""
        th = x.to(self.cdtype)[..., self.orf_par_ix]
        eye = torch.eye(self.P, dtype=self.cdtype, device=self.device)
        return eye + torch.einsum("...j,jpq->...pq", th,
                                  self.orf_B.to(self.cdtype))

    def orf_ginv_k(self, x=None):
        """Inverse ORF stack in the compute dtype: the static (K, P, P)
        stack of a fixed ORF (``x`` is unused), which broadcasts over
        chains; for sampled weights ``G(x)^-1`` per state, (..., K, P,
        P), from the blocked Cholesky inverse (``(L L^T)^-1 = L^-T
        L^-1``; the sampler keeps the weights where G is positive
        definite)."""
        if self.orf_B is None:
            return self.orf_Ginv.to(self.cdtype)
        from ..ops.linalg import blocked_chol_inv

        _, Li = blocked_chol_inv(self.orf_G(x))
        Gi = Li.transpose(-1, -2) @ Li
        return Gi[..., None, :, :].expand(
            Gi.shape[:-2] + (max(self.K, 1), self.P, self.P))

    def gw_cols_valid(self):
        """``(cols, valid, ccl)`` of the common process's columns in
        group-major order ``[sin k=0..K-1 | cos k=0..K-1]``, each (P,
        2K): the b column of group ``t`` per pulsar (out of range where a
        pulsar lacks it), the in-range indicator (compute dtype) and
        indices clipped into range.  A gather through ``ccl`` must be
        masked by ``valid``: a clipped index can collide with a real
        column."""
        cols = torch.cat([self.gw_sin_ix, self.gw_cos_ix], dim=1)
        valid = ((cols >= 0) & (cols < self.Bmax)).to(self.cdtype)
        ccl = torch.clamp(cols, 0, self.Bmax - 1)
        return cols, valid, ccl

    # ---- common / red process views ----------------------------------------

    @staticmethod
    def _take(b, ix):
        return torch.gather(b, -1, ix.expand(b.shape[:-1] + ix.shape[-1:]))

    def gw_tau(self, b):
        """(..., P, K) per-frequency ``(b_sin^2 + b_cos^2)/2``."""
        bs = self._take(b, self.gw_sin_ix)
        bc = self._take(b, self.gw_cos_ix)
        return 0.5 * (bs * bs + bc * bc)

    def red_tau(self, b):
        """(..., P, Kr) coefficient power on the red signal's columns."""
        bs = self._take(b, self.red_sin_ix)
        bc = self._take(b, self.red_cos_ix)
        return 0.5 * (bs * bs + bc * bc)

    def gw_phi(self, x):
        """(..., P, K) common-process prior variance per frequency."""
        xev = self.xe(x)
        if self.gw_kind == "free_spectrum":
            return torch.pow(10.0, 2.0 * self.gx(xev, self.gw_rho_ix))
        return self._psd(self.gw_kind, xev, self.gw_f, self.gw_df,
                         self.gw_hyp_ix)

    def gw_phi_at_red(self, x):
        """(..., P, Kr) common-process phi on the red frequency grid,
        PHI_FLOOR beyond the common mode count."""
        lead = x.shape[:-1]
        Kr = self.red_rho_ix_x.shape[-1]
        out = torch.full(lead + (self.pn, Kr), PHI_FLOOR, dtype=self.cdtype,
                         device=self.device)
        if self.K and self.red_shares_gw:
            n = min(self.K, Kr)
            out[..., :n] = self.gw_phi(x)[..., :n]
        return out

    def red_phi(self, x):
        """(..., P, K) intrinsic-red prior variance on the common grid,
        PHI_FLOOR beyond each pulsar's red modes / without red."""
        lead = x.shape[:-1]
        floor = torch.full(lead + (self.pn, self.K), PHI_FLOOR,
                           dtype=self.cdtype, device=self.device)
        if self.red_kind == "" or not self.red_shares_gw:
            return floor
        xev = self.xe(x)
        if self.red_kind == "infinitepower":
            k = torch.arange(self.K, device=self.device)
            out = torch.where(k < self.Kr, BIG_PHI, floor)
        elif self.red_kind == "free_spectrum":
            vals = torch.pow(10.0, 2.0 * self.gx(xev, self.red_rho_ix))
            n = min(self.K, self.red_rho_ix.shape[-1])
            out = floor.clone()
            out[..., :n] = vals[..., :n]
        elif self.red_kind == "tprocess":
            vals = (self._psd("powerlaw", xev, self.red_f, self.red_df,
                              self.red_hyp_ix[..., :2])
                    * self.gx(xev, self.red_rho_ix))
            n = min(self.K, self.red_rho_ix.shape[-1])
            out = floor.clone()
            out[..., :n] = torch.clamp(vals[..., :n], min=PHI_FLOOR)
        else:
            vals = self._psd(self.red_kind, xev, self.gw_f, self.gw_df,
                             self.red_hyp_ix)
            k = torch.arange(self.K, device=self.device)
            out = torch.where(k < self.Kr, vals, floor)
        return torch.where(self.red_valid[..., None] > 0, out, floor)


# ===========================================================================
# weights carried across: numpy arrays -> the port's tensors
# ===========================================================================

def from_arrays(fields: dict, device=None) -> CompiledPTA:
    """Build the port's :class:`CompiledPTA` from the arrays of a
    compiled model: ``fields`` maps the JAX ``CompiledPTA`` field names
    to numpy arrays / Python values (components as dicts with ``kind``,
    ``cols``, ``f``, ``df``, ``hyp_ix``, ``rho_ix``), plus the pulsar
    names under ``pulsars`` and the flat b columns' names under
    ``b_names`` where the arrays carry them.  Both sides then compute on
    the same model.  The port covers the models of the module docstring,
    with sampled or constant hypers (the constant ones in
    ``const_pool``), kernel ECORR (``ke_eid``, ``ke_par_ix``) and the
    t-process's ``red_f`` / ``red_df``, sampled ORF weights (``orf_B``,
    ``orf_par_ix``) and the coordinates' start values ``pinit`` (NaN:
    drawn) where the arrays carry them.  The model keeps ``fields``
    (:attr:`CompiledPTA.arrays`) for the host oracle, whose float64
    basis, residuals, TOA variances and static prior variances come from
    ``fields["host"]`` (lists of per-pulsar arrays ``T``, ``y``,
    ``sigma2``, ``phi_base``): arrays without it build a model that the
    oracle refuses.  The storage and compute dtypes are the fields'
    ``dtype`` and ``cdtype`` (the JAX ``CompiledPTA`` records both; the
    defaults float32 / float64 where ``fields`` lacks them), not the
    environment's: a float64 JAX model arrives float64.  The Gram segment
    lengths are the environment's (:func:`..config.current_settings`).
    A correlated ORF whose common
    process shares columns with intrinsic red noise (``compile_pta``
    refuses it) or any other PSD or component kind raises
    ``NotImplementedError``."""
    dev = resolve_device(device)
    orf_name = str(fields.get("orf_name", "crn"))
    sampled = fields.get("orf_B") is not None
    if orf_name != "crn":
        if fields["red_kind"] and bool(fields.get("red_shares_gw", True)):
            raise NotImplementedError(
                "correlated ORF with intrinsic red noise sharing the "
                "common process's basis columns is not implemented (build "
                "with model_general, which gives correlated processes "
                "their own columns)")
        if sampled and fields.get("orf_par_ix") is None:
            raise ValueError(f"orf='{orf_name}' needs the positions of its "
                             "sampled weights 'orf_par_ix'")
        if not sampled and fields.get("orf_Ginv") is None:
            raise ValueError(f"orf='{orf_name}' needs its inverse ORF "
                             "stack 'orf_Ginv'")
        gcols = np.concatenate([np.asarray(fields["gw_sin_ix"]),
                                np.asarray(fields["gw_cos_ix"])], axis=1)
        real = gcols[:int(fields["P_real"])]
        if not ((real >= 0) & (real < int(fields["Bmax"]))).all():
            raise NotImplementedError(
                "correlated ORF requires a homogeneous common mode count "
                "across pulsars")
    if fields["gw_kind"] not in ("free_spectrum",) + POWERLAW_KINDS:
        raise NotImplementedError(
            f"common PSD {fields['gw_kind']!r} is not one of the JAX "
            "package's PSDs (models/psd.py), all of which the port "
            "compiles")
    if fields["red_kind"] not in ("free_spectrum", "", "tprocess",
                                  "infinitepower") + POWERLAW_KINDS:
        raise NotImplementedError(
            f"red PSD {fields['red_kind']!r} is not one of the JAX "
            "package's PSDs (models/psd.py), all of which the port "
            "compiles")
    st = current_settings()
    dt = _torch_dtype(fields.get("dtype", settings.dtype), "dtype")
    cdt = _torch_dtype(fields.get("cdtype", settings.cdtype), "cdtype")

    def t(v, dtype=dt):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)

    def f(name, dtype=dt):
        return t(fields[name], dtype)

    def ix(name):
        return f(name, torch.int64)

    comps = []
    for c in fields["components"]:
        if c["kind"] not in ("free_spectrum", "ecorr", "tprocess",
                             "infinitepower") + POWERLAW_KINDS:
            raise NotImplementedError(
                f"GP component {c['kind']!r} is not one of the JAX "
                "compiled model's component kinds, all of which the port "
                "compiles")
        comps.append(GPComponent(
            c["kind"], t(c["cols"], torch.int64), t(c["rho_ix"], torch.int64),
            f=t(c["f"]), df=t(c["df"]), hyp_ix=t(c["hyp_ix"], torch.int64)))
    names = tuple(fields["param_names"])
    red_f = fields.get("red_f")
    red_df = fields.get("red_df")
    if red_f is None:
        red_f = np.ones(np.shape(fields["red_rho_ix"]), np.float32)
        red_df = np.zeros_like(red_f)
    ke = {}
    if fields.get("ke_eid") is not None:
        eid = np.asarray(fields["ke_eid"])
        E = np.shape(fields["ke_par_ix"])[1]
        U = (eid[:, None, :] == np.arange(E)[None, :, None])
        ke = dict(ke_eid=ix("ke_eid"), ke_par_ix=ix("ke_par_ix"),
                  ke_U=t(U, cdt))
    return CompiledPTA(
        P=int(fields["P"]), P_real=int(fields["P_real"]),
        Nmax=int(fields["Nmax"]), Bmax=int(fields["Bmax"]),
        nx=int(fields["nx"]), K=int(fields["K"]), Kr=int(fields["Kr"]),
        param_names=names,
        device=dev, dtype=dt, cdtype=cdt,
        y=f("y"), T=f("T"), toa_mask=f("toa_mask"), psr_mask=f("psr_mask"),
        sigma2=f("sigma2"), efac_ix=ix("efac_ix"), equad_ix=ix("equad_ix"),
        gequad_ix=ix("gequad_ix"), const_pool=f("const_pool"),
        phi_base=f("phi_base"), components=comps,
        pkind=ix("pkind"), pa=f("pa"), pb=f("pb"),
        prop_scale=f("prop_scale"), idx=BlockIndex.build(names),
        gw_sin_ix=ix("gw_sin_ix"), gw_cos_ix=ix("gw_cos_ix"),
        gw_f=f("gw_f"), gw_df=f("gw_df"), gw_kind=str(fields["gw_kind"]),
        gw_hyp_ix=ix("gw_hyp_ix"), gw_rho_ix=ix("gw_rho_ix"),
        rho_ix_x=ix("rho_ix_x"), red_valid=f("red_valid"),
        red_kind=str(fields["red_kind"]), red_hyp_ix=ix("red_hyp_ix"),
        red_rho_ix=ix("red_rho_ix"),
        red_rho_ix_x=ix("red_rho_ix_x"), red_sin_ix=ix("red_sin_ix"),
        red_cos_ix=ix("red_cos_ix"), white_par_ix=ix("white_par_ix"),
        white_nper=ix("white_nper"), ec_cols=ix("ec_cols"),
        ec_ix=ix("ec_ix"), ecorr_par_ix=ix("ecorr_par_ix"),
        ecorr_nper=ix("ecorr_nper"), gp_mask=f("gp_mask"),
        rhomin=float(fields["rhomin"]), rhomax=float(fields["rhomax"]),
        red_rhomin=float(fields["red_rhomin"]),
        red_rhomax=float(fields["red_rhomax"]),
        red_shares_gw=bool(fields.get("red_shares_gw", True)),
        orf_name=orf_name,
        orf_Ginv=(None if orf_name == "crn" or sampled
                  else t(fields["orf_Ginv"], torch.float64)),
        orf_B=t(fields["orf_B"], torch.float64) if sampled else None,
        orf_par_ix=(t(fields["orf_par_ix"], torch.int64) if sampled
                    else None),
        pinit=(None if fields.get("pinit") is None
               else t(fields["pinit"], torch.float64)),
        widths=tuple(int(w) for w in fields["widths"]),
        pulsars=tuple(str(p) for p in fields.get("pulsars", ())),
        b_names=tuple(fields.get("b_names", ())),
        red_f=t(red_f), red_df=t(red_df), **ke, arrays=dict(fields),
        gram_seg_len=st.gram_seg_len,
        gram_seg_len_exact=st.gram_seg_len_exact,
    )


def _torch_dtype(v, name):
    """A float32 / float64 dtype given as a torch dtype, a numpy dtype
    or type, or a name."""
    if isinstance(v, torch.dtype):
        out = v
    else:
        out = {"float32": torch.float32, "float64": torch.float64}.get(
            np.dtype(v).name)
    if out not in (torch.float32, torch.float64):
        raise ValueError(f"fields[{name!r}]={v!r} must be float32 or "
                         "float64")
    return out


#: the keys of the ensemble stage's state and of the device sketch's
ENS_STATE_KEYS = ("lsp", "m", "swap_acc", "swap_try", "stretch_acc",
                  "stretch_try")
SKETCH_STATE_KEYS = ("n", "mean", "m2", "cross", "lag", "tail", "move",
                     "moven")


def _f64_state(arrays, keys, what, device):
    missing = [k for k in keys if k not in arrays]
    if missing:
        raise ValueError(f"{what} lacks {', '.join(missing)}")
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(arrays[k], np.float64),
                               device=dev) for k in keys}


def ens_state_from_arrays(arrays: dict, device=None) -> dict:
    """The ensemble stage's state carried across: the JAX ``ens_state``
    dict (``sampler/ensemble.py::init_ens_state``'s keys, as numpy
    arrays) as the port's float64 tensors on ``device``."""
    return _f64_state(arrays, ENS_STATE_KEYS, "ensemble state", device)


def sketch_state_from_arrays(arrays: dict, device=None) -> dict:
    """The device sketch's state carried across: the JAX sketch-state
    dict (``obs/sketch.py::init_state``'s keys, as numpy arrays) as the
    port's float64 tensors on ``device``, with the port's ``shift`` at 0
    (the JAX sketch sums raw lagged products) where the dict has none."""
    out = _f64_state(arrays, SKETCH_STATE_KEYS, "sketch state", device)
    out["shift"] = (torch.as_tensor(np.array(arrays["shift"], np.float64),
                                    device=out["mean"].device)
                    if "shift" in arrays else torch.zeros_like(out["mean"]))
    return out
