"""The compiled PTA model as tensors on one device.

Port of ``pulsar_timing_gibbsspec_tpu/sampler/compiled.py`` for the CRN
free-spectrum model: ragged per-pulsar shapes padded to ``(P, Nmax)`` /
``(P, Bmax)``, hyperparameter references compiled to integer gathers into
``xe = [x, 0-sentinel, constants]``, and ``phi(x)`` as a scatter-add of
the per-component variances onto the basis columns.

Every method broadcasts over leading batch dimensions of ``x`` / ``b``:
the driver carries the chains as a leading axis, ``x`` of shape
``(C, nx)`` and ``b`` of shape ``(C, P, Bmax)``, where the JAX package
vmaps a single-chain body.

Padding conventions are the JAX package's: TOA pads carry ``y=0, T=0,
sigma2=1, efac=1, equad=-40`` (``N = 1``), basis pads ``phi = 1``, and
scatter/gather pads point one past the end and are dropped.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import resolve_device, settings

#: prior-variance stand-in for the marginalized timing-model columns
#: (the JAX package's ``BIG_PHI``, kept identical)
BIG_PHI = 1e30
#: floor where a process has no variance on a column (``PHI_FLOOR``)
PHI_FLOOR = 1e-30


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

    @classmethod
    def build(cls, param_names) -> "BlockIndex":
        rho, red, red_rho, white, ecorr = [], [], [], [], []
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

        def arr(v):
            return np.asarray(v, dtype=np.int64)

        return cls(list(param_names), arr(rho), arr(red), arr(red_rho),
                   arr(white), arr(ecorr))


@dataclasses.dataclass
class GPComponent:
    """One free-spectrum Fourier-GP component, stacked over pulsars:
    ``cols`` index the basis axis (pad ``Bmax``, dropped on scatter),
    ``rho_ix`` gathers each column's log10_rho out of ``xe``."""

    kind: str
    cols: torch.Tensor       # (P, W) int64
    rho_ix: torch.Tensor     # (P, W) int64


@dataclasses.dataclass
class CompiledPTA:
    """Static device model of a CRN free-spectrum PTA."""

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
    gw_kind: str
    gw_rho_ix: torch.Tensor    # (P, K) -> xe
    rho_ix_x: torch.Tensor     # (K,) -> x
    red_valid: torch.Tensor    # (P,)
    red_kind: str
    red_rho_ix: torch.Tensor   # (P, Kr) -> xe
    red_rho_ix_x: torch.Tensor  # (P, Kr) -> x (pad nx: dropped)
    red_sin_ix: torch.Tensor   # (P, Kr)
    red_cos_ix: torch.Tensor   # (P, Kr)
    white_par_ix: torch.Tensor  # (P, Wp) -> x (pad nx)
    white_nper: torch.Tensor   # (P,)
    rhomin: float
    rhomax: float
    red_rhomin: float
    red_rhomax: float
    red_shares_gw: bool = True
    orf_name: str = "crn"

    # ---- gathers ----------------------------------------------------------

    def xe(self, x):
        """``[x, 0, const_pool]`` in the compute dtype, (..., nx+1+npool)."""
        x = x.to(self.cdtype)
        lead = x.shape[:-1]
        return torch.cat([
            x, x.new_zeros(lead + (1,)),
            self.const_pool.to(self.cdtype).expand(
                lead + self.const_pool.shape)], dim=-1)

    def _ndiag_from(self, xev):
        efac = xev[..., self.efac_ix]
        equad = xev[..., self.equad_ix]
        gequad = xev[..., self.gequad_ix]
        return (efac * efac * self.sigma2 + torch.pow(10.0, 2.0 * equad)
                + torch.pow(10.0, 2.0 * gequad))

    def ndiag(self, x):
        """(..., P, Nmax) diagonal measurement covariance (compute dtype)."""
        return self._ndiag_from(self.xe(x))

    def ndiag_fast(self, x):
        """(..., P, Nmax) measurement covariance in the storage dtype."""
        return self._ndiag_from(self.xe(x).to(self.dtype))

    def _phi_accum(self, x, base, comps, dtype=None):
        """Scatter-add the components' variances onto ``base``; columns
        at index ``Bmax`` (pads) are dropped."""
        dtype = dtype or self.cdtype
        xev = self.xe(x).to(dtype)
        lead = xev.shape[:-1]
        B = self.Bmax
        phi = torch.cat([
            base.to(dtype).expand(lead + base.shape),
            xev.new_zeros(lead + (self.P, 1))], dim=-1)
        for c in comps:
            vals = torch.pow(10.0, 2.0 * xev[..., c.rho_ix])
            phi = phi.scatter_add(
                -1, c.cols.expand(lead + c.cols.shape), vals.to(dtype))
        return phi[..., :B]

    def phi(self, x, dtype=None):
        """(..., P, Bmax) per-column prior variance (pads = 1)."""
        phi = self._phi_accum(x, self.phi_base, self.components, dtype)
        return torch.clamp(phi, min=PHI_FLOOR)

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
        if self.gw_kind != "free_spectrum":
            raise NotImplementedError(
                f"common PSD {self.gw_kind!r} is not in the port yet")
        return torch.pow(10.0, 2.0 * self.xe(x)[..., self.gw_rho_ix])

    def gw_phi_at_red(self, x):
        """(..., P, Kr) common-process phi on the red frequency grid,
        PHI_FLOOR beyond the common mode count."""
        lead = x.shape[:-1]
        Kr = self.red_rho_ix_x.shape[1]
        out = torch.full(lead + (self.P, Kr), PHI_FLOOR, dtype=self.cdtype,
                         device=self.device)
        if self.K and self.red_shares_gw:
            n = min(self.K, Kr)
            out[..., :n] = self.gw_phi(x)[..., :n]
        return out

    def red_phi(self, x):
        """(..., P, K) intrinsic-red prior variance on the common grid,
        PHI_FLOOR beyond each pulsar's red modes / without red."""
        lead = x.shape[:-1]
        floor = torch.full(lead + (self.P, self.K), PHI_FLOOR,
                           dtype=self.cdtype, device=self.device)
        if self.red_kind == "" or not self.red_shares_gw:
            return floor
        if self.red_kind != "free_spectrum":
            raise NotImplementedError(
                f"red PSD {self.red_kind!r} is not in the port yet")
        vals = torch.pow(10.0, 2.0 * self.xe(x)[..., self.red_rho_ix])
        n = min(self.K, self.red_rho_ix.shape[1])
        out = floor.clone()
        out[..., :n] = vals[..., :n]
        return torch.where(self.red_valid[:, None] > 0, out, floor)


# ===========================================================================
# weights carried across: numpy arrays -> the port's tensors
# ===========================================================================

def from_arrays(fields: dict, device=None) -> CompiledPTA:
    """Build the port's :class:`CompiledPTA` from the arrays of a
    compiled model: ``fields`` maps the JAX ``CompiledPTA`` field names
    to numpy arrays / Python values (components as dicts with ``kind``,
    ``cols``, ``rho_ix``).  Both sides then compute on the same
    model.  Raises ``NotImplementedError`` for models the port does not
    cover yet (anything but the CRN free-spectrum model)."""
    dev = resolve_device(device)
    if fields.get("orf_name", "crn") != "crn":
        raise NotImplementedError("correlated ORFs are not in the port yet")
    if fields.get("ke_eid") is not None:
        raise NotImplementedError("kernel ECORR is not in the port yet")
    if np.asarray(fields.get("ec_cols", np.zeros((1, 0)))).shape[1]:
        raise NotImplementedError("ECORR is not in the port yet")
    if fields["gw_kind"] not in ("free_spectrum",):
        raise NotImplementedError(
            f"common PSD {fields['gw_kind']!r} is not in the port yet")
    if fields["red_kind"] not in ("free_spectrum", ""):
        raise NotImplementedError(
            f"red PSD {fields['red_kind']!r} is not in the port yet")
    dt, cdt = settings.dtype, settings.cdtype

    def f(name, dtype=dt):
        return torch.as_tensor(np.asarray(fields[name]), dtype=dtype,
                               device=dev)

    def ix(name):
        return f(name, torch.int64)

    comps = []
    for c in fields["components"]:
        if c["kind"] != "free_spectrum":
            raise NotImplementedError(
                f"GP component {c['kind']!r} is not in the port yet")
        comps.append(GPComponent(
            c["kind"], torch.as_tensor(np.asarray(c["cols"]),
                                       dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(c["rho_ix"]), dtype=torch.int64,
                            device=dev)))
    names = tuple(fields["param_names"])
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
        gw_kind=str(fields["gw_kind"]), gw_rho_ix=ix("gw_rho_ix"),
        rho_ix_x=ix("rho_ix_x"), red_valid=f("red_valid"),
        red_kind=str(fields["red_kind"]), red_rho_ix=ix("red_rho_ix"),
        red_rho_ix_x=ix("red_rho_ix_x"), red_sin_ix=ix("red_sin_ix"),
        red_cos_ix=ix("red_cos_ix"), white_par_ix=ix("white_par_ix"),
        white_nper=ix("white_nper"),
        rhomin=float(fields["rhomin"]), rhomax=float(fields["rhomax"]),
        red_rhomin=float(fields["red_rhomin"]),
        red_rhomax=float(fields["red_rhomax"]),
        red_shares_gw=bool(fields.get("red_shares_gw", True)),
    )
