"""The float64 host view of a compiled model, read by the NumPy oracle.

The JAX package's oracle (``sampler/numpy_backend.py``,
``sampler/numpy_pta.py``) reads its host ``PTA`` object.  The port has
one model builder, whose arrays :func:`.compiled.from_arrays` takes and
keeps on the model (``cm.arrays``); :class:`HostPTA` answers the
oracle's calls from those arrays, per real pulsar at its real (unpadded)
sizes, never from the model's device tensors:

- ``param_names``, ``params`` (:class:`.compiled.Param`), ``pulsars``;
- ``map_params(x)``: the vector ``xe = [x, 0, constants]`` that every
  other call takes (where the JAX model takes a ``{name: value}`` dict);
- ``get_residuals()``, ``get_basis()`` (under kernel ECORR without the
  ECORR columns), ``get_ndiag(xe)``, ``get_phi(xe)``, ``get_lnprior(x)``;
- ``model(ii)``: a :class:`HostPulsar` with the common process ``gw``,
  the intrinsic red noise sharing the Fourier columns ``red``, the basis
  ECORR ``ecorr`` (:class:`HostSignal`, None where absent), the shared
  Fourier signals ``fourier`` and the own-column GPs ``chrom``, and the
  kernel-ECORR epochs ``ke`` ``(eid, E, par_ix)``.

The basis, residuals, TOA variances and static columns' prior
variances come in float64 from the arrays' ``host`` entry (lists of
per-pulsar arrays: ``T``, ``y``, ``sigma2``, ``phi_base``), which
:func:`..models.build.model_arrays` writes; arrays without it are
refused, never read at the storage dtype.  Frequencies, bin widths,
prior bounds and constants are the compiled model's (float32,
widened); powerlaw-family variances are evaluated by the compiled
model's log-space PSDs in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .compiled import _LNPSD_FNS, BIG_PHI, params_of

_F64 = np.float64


class HostSignal:
    """One Gaussian-process signal of one pulsar on the basis columns
    ``cols`` (a slice): ``kind`` is the compiled component's (a free
    spectrum, ``ecorr``, ``tprocess``, ``infinitepower`` or a powerlaw
    family PSD), ``freqs`` / ``df`` its per-column frequencies and bin
    widths, ``hyp_ix`` / ``rho_ix`` its gathers into ``xe``."""

    def __init__(self, name, kind, cols, f, df, hyp_ix, rho_ix):
        if len(cols) and not np.array_equal(
                cols, np.arange(cols[0], cols[0] + len(cols))):
            raise NotImplementedError(
                f"signal {name!r}: the oracle reads contiguous columns")
        self.name, self.kind = name, kind
        self.cols = slice(int(cols[0]), int(cols[0]) + len(cols))
        self.freqs = np.asarray(f, _F64)
        self.df = np.asarray(df, _F64)
        self.hyp_ix = np.asarray(hyp_ix, np.int64)
        self.rho_ix = np.asarray(rho_ix, np.int64)
        self._ec_ix, self._ec_inv = np.unique(self.rho_ix,
                                              return_inverse=True)
        self._f_t = torch.as_tensor(self.freqs)
        self._df_t = torch.as_tensor(self.df)

    def _psd(self, kind, xe, hyp_ix):
        args = [torch.tensor(float(xe[h]), dtype=torch.float64)
                for h in hyp_ix]
        return torch.exp(_LNPSD_FNS[kind](self._f_t, self._df_t,
                                          *args)).numpy()

    def powerlaw(self, xe):
        """Per-column powerlaw of the first two hypers (the t-process's
        amplitude and index)."""
        return self._psd("powerlaw", xe, self.hyp_ix[:2])

    def get_phi(self, xe):
        """Per-column prior variance at ``xe``."""
        if self.kind == "free_spectrum":
            # per frequency, then over the sin/cos pair (the JAX PSD's
            # arithmetic, value for value)
            return np.repeat(10.0 ** (2.0 * xe[self.rho_ix[::2]]), 2)
        if self.kind == "ecorr":
            # a scalar power per backend's parameter, as the JAX signal
            # computes it
            vals = [10.0 ** (2.0 * float(xe[j])) for j in self._ec_ix]
            return np.asarray(vals)[self._ec_inv]
        if self.kind == "infinitepower":
            return np.full(len(self.freqs), BIG_PHI)
        if self.kind == "tprocess":
            return self.powerlaw(xe) * xe[self.rho_ix]
        return self._psd(self.kind, xe, self.hyp_ix)


class HostPulsar:
    """One real pulsar's signals (see the module docstring)."""

    def __init__(self, name, gw, red, ecorr, chrom, ke):
        self.name = name
        self.gw, self.red, self.ecorr, self.chrom, self.ke = (
            gw, red, ecorr, chrom, ke)
        self.fourier = sorted([s for s in (gw, red) if s is not None],
                              key=lambda s: s.cols.start)

    @property
    def signals(self):
        return (self.fourier + self.chrom
                + ([self.ecorr] if self.ecorr is not None else []))


class HostPTA:
    """Float64 host view of the arrays a compiled model was built from
    (``cm.arrays``)."""

    def __init__(self, arrays):
        a = arrays
        names = tuple(a["param_names"])
        self.param_names = list(names)
        self.nx = nx = len(names)
        self.P = P = int(a["P_real"])
        self.pulsars = [str(p) for p in a.get("pulsars", ())] or [
            f"pulsar{ii}" for ii in range(P)]
        pkind = np.asarray(a["pkind"])
        self._pkind = pkind
        self._pa = np.asarray(a["pa"], _F64)
        self._pb = np.asarray(a["pb"], _F64)
        self.params = params_of(names, pkind, self._pa, self._pb)
        self._lgamma_a = np.array([math.lgamma(q) if q > 0 else 0.0
                                   for q in self._pa])
        self._pool = np.asarray(a["const_pool"], _F64)
        self.orf_name = str(a.get("orf_name", "crn"))
        self.Ginv = self.orf_B = self.orf_idx = None
        if a.get("orf_B") is not None:
            self.orf_B = np.asarray(a["orf_B"], _F64)[:, :P, :P]
            self.orf_idx = np.asarray(a["orf_par_ix"], np.int64)
        elif self.orf_name != "crn":
            self.Ginv = np.asarray(a["orf_Ginv"], _F64)[:, :P, :P]

        host = a.get("host")
        if not host:
            raise ValueError(
                "these model arrays carry no float64 host arrays (their "
                "'host' entry): build the model with model_general / "
                "build_crn_spectrum, or pass 'host' to from_arrays")
        toa_mask = np.asarray(a["toa_mask"])
        Bmax = int(a["Bmax"])
        widths = [int(w) for w in a["widths"]]
        gw_cols = np.concatenate([np.asarray(a["gw_sin_ix"]),
                                  np.asarray(a["gw_cos_ix"])], axis=1)
        red_cols = np.concatenate([np.asarray(a["red_sin_ix"]),
                                   np.asarray(a["red_cos_ix"])], axis=1)
        red_valid = np.asarray(a["red_valid"])
        self._T, self._y, self._sigma2, self._phi_base = [], [], [], []
        self._wix, self._models = [], []
        for p in range(P):
            n, w = int(toa_mask[p].sum()), widths[p]
            T = np.asarray(host["T"][p], _F64)
            y = np.asarray(host["y"][p], _F64)
            s2 = np.asarray(host["sigma2"][p], _F64)
            if T.shape != (n, w):
                raise ValueError(f"host basis of pulsar {p} has shape "
                                 f"{T.shape}, the model ({n}, {w})")
            self._T.append(T)
            self._y.append(y)
            self._sigma2.append(s2)
            self._phi_base.append(np.asarray(host["phi_base"][p], _F64))
            self._wix.append(tuple(np.asarray(a[k][p, :n], np.int64)
                                   for k in ("efac_ix", "equad_ix",
                                             "gequad_ix")))
            gw_set = set(int(c) for c in gw_cols[p] if c < Bmax)
            red_set = (set(int(c) for c in red_cols[p] if c < Bmax)
                       if red_valid[p] > 0 else set())
            gw = red = ecorr = None
            chrom = []
            for c in a["components"]:
                cols = np.asarray(c["cols"][p])
                live = cols < Bmax
                if not live.any():
                    continue
                sig = HostSignal(
                    c["kind"], str(c["kind"]), cols[live],
                    np.asarray(c["f"][p])[live], np.asarray(c["df"][p])[live],
                    np.asarray(c["hyp_ix"][p]),
                    np.asarray(c["rho_ix"][p])[live])
                owner = self._owner_name(sig)
                colset = set(int(j) for j in cols[live])
                if sig.kind == "ecorr":
                    sig.name = "ecorr"
                    ecorr = sig
                elif (gw is None and colset == gw_set
                      and (owner is None or "gw" in owner)):
                    sig.name = "gw"
                    gw = sig
                elif red is None and red_set and colset == red_set:
                    sig.name = "red"
                    red = sig
                else:
                    sig.name = owner or sig.kind
                    chrom.append(sig)
            ke = None
            if a.get("ke_eid") is not None:
                eid = np.asarray(a["ke_eid"][p, :n], np.int64)
                Emax = np.shape(a["ke_par_ix"])[1]
                real = eid[eid < Emax]
                E = int(real.max()) + 1 if len(real) else 0
                if E:
                    ke = (np.where(eid >= E, E, eid), E,
                          np.asarray(a["ke_par_ix"][p, :E], np.int64))
            self._models.append(HostPulsar(self.pulsars[p], gw, red, ecorr,
                                           chrom, ke))

    def _owner_name(self, sig):
        """The name of the first sampled parameter a signal reads, None
        when every one is a constant."""
        for ix in list(sig.rho_ix) + list(sig.hyp_ix):
            if ix < self.nx:
                return self.param_names[int(ix)]
        return None

    # ---- the oracle's calls ------------------------------------------------

    def map_params(self, xs):
        """``xe = [x, 0, constants]`` (float64) of one chain vector."""
        return np.concatenate([np.asarray(xs, _F64), [0.0], self._pool])

    def get_residuals(self):
        return self._y

    def get_basis(self):
        return self._T

    def get_ndiag(self, xe):
        """Per pulsar ``efac^2 sigma^2 + 10^(2 equad) + 10^(2 gequad)``
        (a missing term is the constant -40: it adds nothing)."""
        out = []
        for s2, (ef, eq, geq) in zip(self._sigma2, self._wix):
            out.append(xe[ef] ** 2 * s2 + 10.0 ** (2.0 * xe[eq])
                       + 10.0 ** (2.0 * xe[geq]))
        return out

    def get_phi(self, xe):
        """Per pulsar per-column prior variance."""
        out = []
        for base, m in zip(self._phi_base, self._models):
            phi = base.copy()
            for s in m.signals:
                phi[s.cols] += s.get_phi(xe)
            out.append(phi)
        return out

    def get_lnprior(self, xs):
        """Joint prior log-density of ``xs`` (nx,)."""
        v = np.asarray(xs, _F64)
        a, b, k = self._pa, self._pb, self._pkind
        inside = (v >= a) & (v <= b)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            lp = np.where(inside, -np.log(b - a), -np.inf)
            lp = np.where(k == 1, -0.5 * ((v - a) / b) ** 2
                          - np.log(b * math.sqrt(2.0 * math.pi)), lp)
            lin = np.log(math.log(10.0) * 10.0 ** v
                         / (10.0 ** b - 10.0 ** a))
            lp = np.where(k == 2, np.where(inside, lin, -np.inf), lp)
            vp = np.maximum(v, 1e-30)
            ig = a * np.log(b) - self._lgamma_a - (a + 1.0) * np.log(vp) - b / vp
            lp = np.where(k == 3, np.where(v > 0, ig, -np.inf), lp)
        return float(np.sum(lp))

    def model(self, ii):
        """The :class:`HostPulsar` of real pulsar ``ii`` (index or name)."""
        if isinstance(ii, str):
            ii = self.pulsars.index(ii)
        return self._models[ii]


def host_view(cm) -> HostPTA:
    """The :class:`HostPTA` of a compiled model, from the arrays it was
    built from (``cm.arrays``)."""
    if cm.arrays is None:
        raise ValueError(
            "this compiled model keeps no host arrays: build it with "
            "model_general / build_crn_spectrum / from_arrays")
    return HostPTA(cm.arrays)
