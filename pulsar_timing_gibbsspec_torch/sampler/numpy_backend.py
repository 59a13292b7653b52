"""The NumPy oracle for one pulsar: reference-faithful blocked Gibbs in
float64 on the host (``backend="numpy"``).

The port's copy of ``pulsar_timing_gibbsspec_tpu/sampler/
numpy_backend.py::NumpyGibbs``, reading the port's model through its
host view (:class:`.host_model.HostPTA`).  It implements the reference
``PulsarBlockGibbs`` sweep (the van Haasteren & Vallisneri (2014)
conditional draws) with ``numpy.random.Generator`` draws of the JAX
oracle's shapes and order, so the two oracles agree draw for draw on one
model and one seed.  It is the statistical reference the card's chains
are held against.

Blocks per sweep, in the reference order:

1. white-noise EFAC/EQUAD: single-site MH on the b-conditional diagonal
   likelihood; the first sweep runs ``white_adapt_iters`` adaptation
   steps and sizes later sub-chains by the measured ACT;
2. ECORR (basis coefficients, or kernel ECORR's Woodbury white
   likelihood), adapted alike;
3. free-spectrum red (grid draw), t-process alphas (grid draw), and the
   powerlaw-family hypers: adaptive MH (DE, SCAM, AM and single-site
   jumps) whose covariance is adapted on the first sweep from a
   marginalized-likelihood run;
4. common rho: the exact inverse-CDF draw without intrinsic red noise,
   else Gumbel-max on the 1000-point log grid;
5. b: the Gaussian draw with covariance ``(T^T N^-1 T + diag(phi^-1))^-1``
   (SVD factor).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sl

from ..ops.acf import integrated_act
from .blocks import (TP_ALPHA_GRID, TP_ALPHA_LOG10_MAX, TP_ALPHA_LOG10_MIN,
                     validate_sampling_flags)
from .compiled import BlockIndex
from .oracle_blocks import (align_phi, de_hist_push, de_step,
                            gumbel_grid_draw, ke_corr, ke_tnt_corr,
                            ke_woodbury, proposal_step, rho_bounds,
                            rho_grid, rho_log_pdf_grid, rng_state_pack,
                            rng_state_unpack, seed_red_hist,
                            tprocess_alpha_log_pdf_grid)

#: adaptation-state keys of ``adapt.npz`` besides the generator and b
_STATE_KEYS = ("aclength_white", "cov_white", "cov_red", "red_hist",
               "aclength_ecorr", "_red_pend", "_red_count")


class NumpyGibbs:
    """Single-pulsar oracle sampler over a host view ``pta``
    (:class:`.host_model.HostPTA`)."""

    def __init__(self, pta, hypersample=None, redsample=None,
                 ecorrsample=None,
                 white_adapt_iters=1000, red_adapt_iters=2000, red_steps=20,
                 seed=None):
        self.pta = pta
        if pta.P != 1:
            raise ValueError("NumpyGibbs is single-pulsar; use the PTA facade")
        validate_sampling_flags(pta, hypersample, ecorrsample, redsample)
        self.hypersample = hypersample
        self.redsample = redsample
        self.white_adapt_iters = white_adapt_iters
        self.red_adapt_iters = red_adapt_iters
        self.red_steps = red_steps
        self.rng = np.random.default_rng(seed)

        self.idx = BlockIndex.build(pta.param_names)
        self._y = pta.get_residuals()[0]
        self._T = pta.get_basis()[0]
        self._model = m = pta.model(0)

        self.gwid = np.arange(m.gw.cols.start, m.gw.cols.stop)
        try:
            self.rhomin, self.rhomax = rho_bounds(pta, "gw")
        except ValueError:   # powerlaw-family common process: no rho block
            self.rhomin, self.rhomax = 1e-20, 1e-8
        try:
            self.red_rhomin, self.red_rhomax = rho_bounds(pta, "red")
        except ValueError:
            self.red_rhomin, self.red_rhomax = self.rhomin, self.rhomax

        # the shared-column Fourier red alone: band/backend splits live
        # on columns of their own and are sampled by the hyper MH block
        self.red_sig = m.red
        self._alpha_idx = None
        if self.red_sig is not None:
            self.redid = np.arange(m.red.cols.start, m.red.cols.stop)
            if self.red_sig.kind == "tprocess":
                self._alpha_idx = self.red_sig.rho_ix[::2]
        self.gw_sig = m.gw
        # do red and gw share basis columns?  (CRN: yes; a correlated
        # own-column common process: no)
        self._red_shares_gw = (
            self.red_sig is not None and self.gw_sig is not None
            and len(np.intersect1d(self.redid, self.gwid)) > 0)
        if len(self.idx.rho) and len(self.idx.rho) != len(self.gwid) // 2:
            raise ValueError(
                f"found {len(self.idx.rho)} free-spectrum rho parameters but "
                f"{len(self.gwid) // 2} GW frequencies — the conditional rho "
                "draw requires exactly one 'spectrum' common process (use "
                "a single orf entry with common_psd='spectrum')")
        self.ecorr_sig = m.ecorr
        if self.ecorr_sig is not None:
            self.ecid = np.arange(m.ecorr.cols.start, m.ecorr.cols.stop)

        # kernel ECORR: the epoch blocks live inside N (Woodbury); a
        # model compiled so has no ECORR columns, whatever the selector
        self.kernel_ecorr = m.ke is not None
        if ecorrsample == "kernel" and not self.kernel_ecorr:
            raise ValueError(
                "ecorrsample='kernel' but the model has no ECORR signal")
        if self.kernel_ecorr:
            self._ke_eid, self._ke_E, self._ke_par = m.ke

        self.nb_total = self._T.shape[1]
        self.b = np.zeros(self._T.shape[1])
        # per-sweep caches (invalidated when white params move)
        self._TNT = None
        self._d = None

        # adaptation state (checkpointable)
        self.aclength_white = None
        self.cov_white = None
        self.cov_red = None
        self.red_hist = None
        self._red_pend = None
        self._red_count = 0
        self.aclength_ecorr = None

    # ---- parameter helpers -------------------------------------------------

    def map_params(self, xs):
        return self.pta.map_params(xs)

    def get_lnprior(self, xs):
        return self.pta.get_lnprior(xs)

    # ---- likelihoods -------------------------------------------------------

    def _ndiag(self, xs):
        return self.pta.get_ndiag(self.map_params(xs))[0]

    def _ensure_cache(self, Nvec):
        if self._TNT is None or self._d is None:
            self._TNT = self._T.T @ (self._T / Nvec[:, None])
            self._d = self._T.T @ (self._y / Nvec)

    def invalidate_cache(self):
        self._TNT = None
        self._d = None

    def _ke_corr(self, params, Nvec, r):
        return ke_corr(params, Nvec, r, self._ke_eid, self._ke_E,
                       self._ke_par)

    def _tnt_d(self, params, Nvec):
        """Per-sweep ``(T^T N^-1 T, T^T N^-1 y)``; the kernel-ECORR
        correction is applied at use time (it moves with the ECORR
        parameters, unlike the cached diagonal part)."""
        self._ensure_cache(Nvec)
        if not self.kernel_ecorr:
            return self._TNT, self._d
        _, _, w = ke_woodbury(params, Nvec, self._ke_eid, self._ke_E,
                              self._ke_par)
        corr = ke_tnt_corr(self._T, self._y, Nvec, w, self._ke_eid,
                           self._ke_E)
        return self._TNT - corr[:-1, :-1], self._d - corr[:-1, -1]

    def lnlike_white(self, xs):
        """Gaussian likelihood of ``y - T b``: diagonal N, plus the
        per-epoch Woodbury terms under kernel ECORR."""
        Nvec = self._ndiag(xs)
        r = self._y - self._T @ self.b
        out = -0.5 * (np.sum(np.log(Nvec)) + np.sum(r * r / Nvec))
        if self.kernel_ecorr:
            out += self._ke_corr(self.map_params(xs), Nvec, r)
        return out

    def _gw_tau(self):
        """Per-frequency (sin^2 + cos^2)/2 of the GW coefficients."""
        bb = self.b[self.gwid] ** 2
        return 0.5 * (bb[::2] + bb[1::2])

    def _red_phi_at_gw_freqs(self, params):
        """Intrinsic-red phi on the GW frequency grid: truncated when the
        red process has more modes, floor-padded when it has fewer."""
        kgw = len(self.gwid) // 2
        if self.red_sig is None:
            return np.full(kgw, 1e-30)
        return align_phi(np.asarray(self.red_sig.get_phi(params))[::2], kgw)

    def lnlike_red(self, xs):
        """b-conditional likelihood of every GP hyper: the N(0, phi(x))
        terms of the whole shared Fourier block and of each own-column
        GP."""
        params = self.map_params(xs)
        out = 0.0
        m = self._model
        if m.fourier:
            # shared block: per-column phi sums every Fourier signal
            start = min(s.cols.start for s in m.fourier)
            stop = max(s.cols.stop for s in m.fourier)
            phi = np.zeros(stop - start)
            for s in m.fourier:
                phi[s.cols.start - start:s.cols.stop - start] += \
                    np.asarray(s.get_phi(params))
            bb = self.b[start:stop]
            out += float(np.sum(-0.5 * np.log(phi)
                                - 0.5 * bb * bb / phi))
        for s in m.chrom:
            phi = np.asarray(s.get_phi(params))
            bb = self.b[s.cols]
            out += float(np.sum(-0.5 * np.log(phi)
                                - 0.5 * bb * bb / phi))
        return out

    def lnlike_ecorr(self, xs):
        """b-conditional likelihood of the ECORR variances: the ECORR
        basis coefficients are iid N(0, phi_j)."""
        params = self.map_params(xs)
        phi = np.asarray(self.ecorr_sig.get_phi(params))
        bj = self.b[self.ecid]
        return float(np.sum(-0.5 * np.log(phi) - 0.5 * bj * bj / phi))

    def lnlike_fullmarg(self, xs):
        """b-marginalized likelihood."""
        params = self.map_params(xs)
        Nvec = self.pta.get_ndiag(params)[0]
        phi = self.pta.get_phi(params)[0]
        phiinv, logdet_phi = 1.0 / phi, float(np.sum(np.log(phi)))
        TNT, d = self._tnt_d(params, Nvec)
        out = -0.5 * (np.sum(np.log(Nvec)) + np.sum(self._y**2 / Nvec))
        if self.kernel_ecorr:
            out += self._ke_corr(params, Nvec, self._y)
        Sigma = TNT + np.diag(phiinv)
        try:
            cf = sl.cho_factor(Sigma)
        except np.linalg.LinAlgError:
            return -np.inf
        expval = sl.cho_solve(cf, d)
        logdet_sigma = 2.0 * np.sum(np.log(np.diag(cf[0])))
        return float(out + 0.5 * (d @ expval - logdet_sigma - logdet_phi))

    # ---- conditional draws -------------------------------------------------

    def draw_b(self, xs):
        """b | everything: N(Sigma^-1 d, Sigma^-1) by an SVD factor (QR
        where the SVD does not converge)."""
        params = self.map_params(xs)
        Nvec = self.pta.get_ndiag(params)[0]
        phiinv = 1.0 / self.pta.get_phi(params)[0]
        TNT, d = self._tnt_d(params, Nvec)
        Sigma = TNT + np.diag(phiinv)
        try:
            u, s, _ = sl.svd(Sigma)
            mn = u @ ((u.T @ d) / s)
            Li = u * np.sqrt(1.0 / s)
        except np.linalg.LinAlgError:
            Q, R = sl.qr(Sigma)
            Sigi = sl.solve(R, Q.T)
            mn = Sigi @ d
            u, s, _ = sl.svd(Sigi)
            Li = u * np.sqrt(s)
        self.b = mn + Li @ self.rng.standard_normal(len(mn))
        return self.b

    def update_rho(self, xs):
        """Free-spectrum conditional draw of the common rho."""
        xnew = xs.copy()
        tau = self._gw_tau()
        if self.red_sig is None:
            # exact truncated inverse CDF; tau = 0 (a zeroed coefficient
            # pair) is clamped as on the device
            tau = np.maximum(tau, self.rhomin * 1e-6)
            hi = 1.0 - np.exp(tau / self.rhomax - tau / self.rhomin)
            eta = self.rng.uniform(0.0, hi)
            rhonew = tau / (tau / self.rhomax - np.log1p(-eta))
        else:
            # the red 'other' applies only on shared columns
            irn = (self._red_phi_at_gw_freqs(self.map_params(xnew))
                   if self._red_shares_gw
                   else np.full(len(tau), 1e-30))
            grid = rho_grid(self.rhomin, self.rhomax)
            rhonew = gumbel_grid_draw(self.rng,
                                      rho_log_pdf_grid(tau, irn, grid), grid)
        xnew[self.idx.rho] = 0.5 * np.log10(rhonew)
        return xnew

    def _mh_loop(self, xs, idx, lnlike, nsteps, sigma, record=None):
        """Single-site Metropolis loop with the reference proposal mixture."""
        x = xs.copy()
        ll0 = lnlike(x)
        lp0 = self.get_lnprior(x)
        for ii in range(nsteps):
            q = proposal_step(self.rng, x, idx, sigma)
            lp1 = self.get_lnprior(q)
            ll1 = lnlike(q) if np.isfinite(lp1) else -np.inf
            if (ll1 + lp1) - (ll0 + lp0) > np.log(self.rng.uniform()):
                x, ll0, lp0 = q, ll1, lp1
            if record is not None:
                record[ii] = x[idx]
        return x

    def update_white(self, xs, adapt=False):
        """EFAC/EQUAD block: the adaptation run once, then ACT-sized
        sub-chains."""
        wind = self.idx.white
        sigma = 0.05 * len(wind)
        if adapt:
            rec = np.zeros((self.white_adapt_iters, len(wind)))
            xnew = self._mh_loop(xs, wind, self.lnlike_white,
                                 self.white_adapt_iters, sigma, record=rec)
            burn = rec[min(100, len(rec) // 2):]
            self.cov_white = np.atleast_2d(np.cov(burn, rowvar=False))
            self.aclength_white = int(max(
                1, max(int(integrated_act(burn[:, j])) for j in range(len(wind)))))
            return xnew
        return self._mh_loop(xs, wind, self.lnlike_white,
                             self.aclength_white, sigma)

    def update_red(self, xs, adapt=False):
        """Powerlaw-family hyper block: the adaptation run estimates the
        block covariance on the marginalized likelihood; per-sweep steps
        mix differential-evolution, covariance (SCAM), full-covariance
        (AM) and single-site jumps on the b-conditional likelihood."""
        rind = self.idx.red
        if adapt:
            rec = np.zeros((self.red_adapt_iters, len(rind)))
            xnew = self._mh_loop(xs, rind, self.lnlike_fullmarg,
                                 self.red_adapt_iters, 0.05 * len(rind),
                                 record=rec)
            burn = rec[min(100, len(rec) // 2):]
            self.cov_red = np.atleast_2d(np.cov(burn, rowvar=False))
            self.cov_red += 1e-12 * np.eye(len(rind))
            self._red_eigs = np.linalg.svd(self.cov_red)
            self.red_hist = seed_red_hist(burn)
            self._red_pend = self.red_hist.copy()
            self._red_count = 0
            return xnew

        x = xs.copy()
        ll0 = self.lnlike_red(x)
        lp0 = self.get_lnprior(x)
        U, S, _ = self._red_eigs
        am_sqrt = U * np.sqrt(S)[None, :]
        for _ in range(self.red_steps):
            r = self.rng.uniform()
            if r < 0.5:
                q = de_step(self.rng, x, rind, self.red_hist)
            elif r < 0.65:
                # SCAM: one adapted eigendirection
                q = x.copy()
                j = self.rng.integers(len(rind))
                step = 2.38 * np.sqrt(S[j]) * self.rng.standard_normal()
                q[rind] += step * U[:, j]
            elif r < 0.8:
                # AM: the full adapted covariance
                q = x.copy()
                z = self.rng.standard_normal(len(rind))
                q[rind] += (2.38 / np.sqrt(len(rind))) * (am_sqrt @ z)
            else:
                q = proposal_step(self.rng, x, rind, 0.05 * len(rind))
            lp1 = self.get_lnprior(q)
            ll1 = self.lnlike_red(q) if np.isfinite(lp1) else -np.inf
            if (ll1 + lp1) - (ll0 + lp0) > np.log(self.rng.uniform()):
                x, ll0, lp0 = q, ll1, lp1
        self.red_hist, self._red_pend, self._red_count = de_hist_push(
            self.red_hist, self._red_pend, self._red_count, x[rind])
        return x

    def update_red_rho(self, xs):
        """Per-frequency free-spectrum draw of the intrinsic red process
        with the common phi as the 'other' variance."""
        xnew = xs.copy()
        params = self.map_params(xnew)
        bb = self.b[self.redid] ** 2
        tau = 0.5 * (bb[::2] + bb[1::2])
        K = len(self.idx.red_rho)
        tau = tau[:K]
        gw = (align_phi(np.asarray(self.gw_sig.get_phi(params))[::2], K)
              if self._red_shares_gw else np.full(K, 1e-30))
        grid = rho_grid(self.red_rhomin, self.red_rhomax)
        xnew[self.idx.red_rho] = 0.5 * np.log10(gumbel_grid_draw(
            self.rng, rho_log_pdf_grid(tau, gw, grid), grid))
        return xnew

    def update_tprocess_alpha(self, xs):
        """Grid draw of the t-process scale factors from their conditional
        with the shared common-process variance ``o``: ``p(alpha | b) ~
        alpha^-2 e^(-1/alpha) (o + alpha plaw)^-1 e^(-tau/(o + alpha
        plaw))``."""
        xnew = xs.copy()
        params = self.map_params(xnew)
        bb = self.b[self.redid] ** 2
        tau = 0.5 * (bb[::2] + bb[1::2])
        plaw = self.red_sig.powerlaw(params)[::2]
        other = (align_phi(np.asarray(self.gw_sig.get_phi(params))[::2],
                           len(tau))
                 if self.gw_sig is not None and self._red_shares_gw
                 else np.full(len(tau), 1e-30))
        grid = 10.0 ** np.linspace(TP_ALPHA_LOG10_MIN, TP_ALPHA_LOG10_MAX,
                                   TP_ALPHA_GRID)
        logpdf = tprocess_alpha_log_pdf_grid(tau, plaw, other, grid)
        xnew[self._alpha_idx] = gumbel_grid_draw(self.rng, logpdf, grid)
        return xnew

    def update_ecorr(self, xs, adapt=False):
        """ECORR block by MH on the basis coefficients' conditional or,
        under kernel ECORR, on the Woodbury white likelihood given b."""
        eind = self.idx.ecorr
        sigma = 0.05 * len(eind)
        target = self.lnlike_white if self.kernel_ecorr else self.lnlike_ecorr
        if adapt:
            rec = np.zeros((self.white_adapt_iters, len(eind)))
            xnew = self._mh_loop(xs, eind, target,
                                 self.white_adapt_iters, sigma, record=rec)
            burn = rec[min(100, len(rec) // 2):]
            self.aclength_ecorr = int(max(
                1, max(int(integrated_act(burn[:, j])) for j in range(len(eind)))))
            return xnew
        return self._mh_loop(xs, eind, target,
                             self.aclength_ecorr, sigma)

    # ---- sweep -------------------------------------------------------------

    def sweep(self, xs, first=False):
        """One full Gibbs sweep in the reference order."""
        x = np.asarray(xs, dtype=np.float64).copy()
        if first:
            self.draw_b(x)
        self.invalidate_cache()
        if len(self.idx.white):
            x = self.update_white(x, adapt=first)
        if len(self.idx.ecorr) and (self.ecorr_sig is not None
                                    or self.kernel_ecorr):
            x = self.update_ecorr(x, adapt=first)
        if len(self.idx.red_rho):
            x = self.update_red_rho(x)
        if self._alpha_idx is not None:
            x = self.update_tprocess_alpha(x)
        if len(self.idx.red):
            x = self.update_red(x, adapt=first)
        if len(self.idx.rho):
            x = self.update_rho(x)
        self.draw_b(x)
        return x

    # ---- adaptation state for resume ---------------------------------------

    def adapt_state(self) -> dict:
        out = {"rng_state": rng_state_pack(self.rng), "b": self.b}
        for key in _STATE_KEYS:
            val = getattr(self, key, None)
            if val is not None:
                out[key] = np.asarray(val)
        return out

    def load_adapt_state(self, state: dict):
        rng_state_unpack(self.rng, state["rng_state"])
        self.b = np.asarray(state["b"])
        for key in _STATE_KEYS:
            if key in state:
                val = state[key]
                setattr(self, key, int(val) if val.ndim == 0 else np.asarray(val))
        if self.cov_red is not None:
            self._red_eigs = np.linalg.svd(self.cov_red)
            if self.red_hist is None:
                raise RuntimeError(
                    "resume checkpoint lacks the red-block DE history "
                    "(red_hist) — it was written by an incompatible "
                    "version; delete the chain directory to start fresh")
            if getattr(self, "_red_pend", None) is None:
                self._red_pend = np.asarray(self.red_hist).copy()
                self._red_count = 0
