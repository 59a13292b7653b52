"""The NumPy oracle for an array: multi-pulsar blocked Gibbs with a
common spectrum, in float64 on the host (``backend="numpy"``).

The port's copy of ``pulsar_timing_gibbsspec_tpu/sampler/numpy_pta.py::
NumpyPTAGibbs``, reading the port's model through its host view
(:class:`.host_model.HostPTA`), with the JAX oracle's draws in shape
and order.  The cross-pulsar coupling of a CRN model is the common
free-spectrum conditional alone (per-pulsar log-PDF grids summed before
the Gumbel-max draw); white noise, intrinsic red and the b-draws are per
pulsar.  A correlated ORF (fixed, or with sampled weights) adds the
joint b-draw over all pulsars and the quadratic-form rho conditional.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sl

from ..ops.acf import integrated_act
from .blocks import (TP_ALPHA_GRID, TP_ALPHA_LOG10_MAX, TP_ALPHA_LOG10_MIN,
                     validate_sampling_flags)
from .compiled import BlockIndex
from .numpy_backend import _STATE_KEYS
from .oracle_blocks import (align_phi, de_hist_push, de_step,
                            gumbel_grid_draw, ke_corr, ke_tnt_corr,
                            ke_woodbury, proposal_step, rho_bounds,
                            rho_grid, rho_log_pdf_grid, rng_state_pack,
                            rng_state_unpack, seed_red_hist,
                            tprocess_alpha_log_pdf_grid)


class NumpyPTAGibbs:
    """Multi-pulsar oracle sampler over a host view ``pta``
    (:class:`.host_model.HostPTA`): common GW free spectrum and per-pulsar
    noise blocks."""

    def __init__(self, pta, hypersample=None, redsample=None,
                 ecorrsample=None,
                 white_adapt_iters=1000, red_adapt_iters=2000, red_steps=20,
                 seed=None):
        self.pta = pta
        self.P = pta.P
        validate_sampling_flags(pta, hypersample, ecorrsample, redsample)
        self.hypersample = hypersample
        self.redsample = redsample
        self.white_adapt_iters = white_adapt_iters
        self.red_adapt_iters = red_adapt_iters
        self.red_steps = red_steps
        self.rng = np.random.default_rng(seed)

        self.idx = BlockIndex.build(pta.param_names)
        self._y = pta.get_residuals()
        self._T = pta.get_basis()
        try:
            self.rhomin, self.rhomax = rho_bounds(pta, "gw")
        except ValueError:   # powerlaw-family common process: no rho block
            self.rhomin, self.rhomax = 1e-20, 1e-8

        self.gwid, self.red_sigs, self.gw_sigs, self.ecorr_sigs = [], [], [], []
        self.redid = []
        self.ecid = []
        #: per pulsar, the chain columns of its red free-spectrum
        #: parameters and of its t-process scale factors
        self.red_rho_idx = []
        self.alpha_idx = []
        nx = len(pta.param_names)
        self._ke = []
        for ii in range(self.P):
            m = pta.model(ii)
            self.gwid.append(np.arange(m.gw.cols.start, m.gw.cols.stop))
            red_sig = m.red
            self.red_sigs.append(red_sig)
            live = np.zeros(0, np.int64)
            if red_sig is not None:
                self.redid.append(np.arange(red_sig.cols.start,
                                            red_sig.cols.stop))
                live = red_sig.rho_ix[::2]
                live = live[live < nx]
            else:
                self.redid.append(None)
            tp = red_sig is not None and red_sig.kind == "tprocess"
            self.red_rho_idx.append(
                live if red_sig is not None
                and red_sig.kind == "free_spectrum"
                else np.zeros(0, np.int64))
            self.alpha_idx.append(live if tp else np.zeros(0, np.int64))
            self.gw_sigs.append(m.gw)
            self.ecorr_sigs.append(m.ecorr)
            if m.ecorr is not None:
                self.ecid.append(np.arange(m.ecorr.cols.start,
                                           m.ecorr.cols.stop))
            else:
                self.ecid.append(None)
            self._ke.append(m.ke)
        if len(self.idx.rho) and len(self.idx.rho) != len(self.gwid[0]) // 2:
            raise ValueError(
                "the common conditional rho draw requires exactly one "
                "'spectrum' common process matching the GW mode count")

        #: per pulsar: do red and gw share basis columns?  (CRN: yes; a
        #: correlated own-column common process: no)
        self._red_shares_gw = [
            self.redid[ii] is not None
            and len(np.intersect1d(self.redid[ii], self.gwid[ii])) > 0
            for ii in range(self.P)]

        # ---- correlated common process (Hellings-Downs etc.) --------------
        # the joint cross-pulsar b-draw and the quadratic-form rho
        # conditional; the ORF's (K, P, P) inverse stack, or its sampled
        # weights' basis, come with the compiled model
        self.orf_name = pta.orf_name
        self.G = None
        self.orf_B = None
        if self.orf_name != "crn":
            self._K = len(self.gwid[0]) // 2
            if pta.orf_B is not None:
                # sampled correlation weights: G(theta) = I + sum theta B
                if not len(self.idx.rho):
                    raise NotImplementedError(
                        "parameterized ORFs are implemented for a varied "
                        "common free spectrum (common_psd='spectrum'); "
                        "the update_orf likelihood needs the rho block")
                self.orf_B = pta.orf_B
                self.orf_idx = pta.orf_idx
                self.G = np.eye(self.P)   # non-None: correlated paths on
                self.Ginv = None          # rebuilt per state
            else:
                self.G = np.eye(self.P)
                self.Ginv = pta.Ginv

        # kernel ECORR: the host view's bases carry no ECORR columns;
        # each pulsar with epochs keeps (eid, E, par_ix)
        self.kernel_ecorr = any(k is not None for k in self._ke)
        if ecorrsample == "kernel" and not self.kernel_ecorr:
            raise ValueError(
                "ecorrsample='kernel' but no pulsar has an ECORR signal")
        if not self.kernel_ecorr:
            self._ke = None

        self.nb_total = sum(T.shape[1] for T in self._T)
        self.b = [np.zeros(T.shape[1]) for T in self._T]
        self._TNT = None
        self._d = None
        self._tnt_ke_cache = {}

        self.aclength_white = None
        self.cov_white = None
        self.cov_red = None
        self.red_hist = None
        self._red_pend = None
        self._red_count = 0
        self.aclength_ecorr = None

    # ---- helpers -----------------------------------------------------------

    def map_params(self, xs):
        return self.pta.map_params(xs)

    def get_lnprior(self, xs):
        return self.pta.get_lnprior(xs)

    def invalidate_cache(self):
        self._TNT = None
        self._d = None
        self._tnt_ke_cache = {}

    def _ensure_cache(self, Nvecs):
        if self._TNT is None:
            self._TNT = [T.T @ (T / N[:, None]) for T, N in zip(self._T, Nvecs)]
            self._d = [T.T @ (y / N) for T, y, N in zip(self._T, self._y, Nvecs)]

    def _gw_tau(self, ii):
        bb = self.b[ii][self.gwid[ii]] ** 2
        return 0.5 * (bb[::2] + bb[1::2])

    def _red_tau(self, ii):
        """Coefficient power on the red signal's own columns — distinct
        from the GW fold when the red process has more modes."""
        bb = self.b[ii][self.redid[ii]] ** 2
        return 0.5 * (bb[::2] + bb[1::2])

    # ---- likelihoods -------------------------------------------------------

    def _ke_corr_ii(self, params, Nvec, r, ii):
        """Woodbury correction to pulsar ``ii``'s diagonal log-density."""
        eid, E, par_ix = self._ke[ii]
        return ke_corr(params, Nvec, r, eid, E, par_ix)

    def _tnt_d_ii(self, params, Nvecs, ii):
        """Pulsar ``ii``'s ``(T^T N^-1 T, T^T N^-1 y)`` with the kernel-
        ECORR correction applied at use time (it moves with the ECORR
        parameters, unlike the cached diagonal part).  Memoized on the
        ECORR parameter values: the red MH block evaluates the
        marginalized likelihood thousands of times per adaptation with
        the white/ECORR state frozen, and the correction is loop-
        invariant there.  ``invalidate_cache`` clears the memo alongside
        the diagonal Gram cache."""
        self._ensure_cache(Nvecs)
        if self._ke is None or self._ke[ii] is None:
            return self._TNT[ii], self._d[ii]
        eid, E, par_ix = self._ke[ii]
        ckey = (ii,) + tuple(params[par_ix].tolist())
        hit = self._tnt_ke_cache.get(ckey)
        if hit is not None:
            return hit
        _, _, w = ke_woodbury(params, Nvecs[ii], eid, E, par_ix)
        corr = ke_tnt_corr(self._T[ii], self._y[ii], Nvecs[ii], w, eid, E)
        out = (self._TNT[ii] - corr[:-1, :-1], self._d[ii] - corr[:-1, -1])
        self._tnt_ke_cache[ckey] = out
        return out

    def lnlike_white(self, xs):
        params = self.map_params(xs)
        Nvecs = self.pta.get_ndiag(params)
        out = 0.0
        for ii in range(self.P):
            r = self._y[ii] - self._T[ii] @ self.b[ii]
            out += -0.5 * (np.sum(np.log(Nvecs[ii]))
                           + np.sum(r * r / Nvecs[ii]))
            if self._ke is not None and self._ke[ii] is not None:
                out += self._ke_corr_ii(params, Nvecs[ii], r, ii)
        return out

    def lnlike_red(self, xs):
        """b-conditional likelihood of all per-pulsar GP hypers: per-column
        N(0, phi(x)) terms over the whole shared Fourier block (not
        truncated to the GW grid) plus chromatic own-column GPs — the same
        generic target as the device backend."""
        params = self.map_params(xs)
        out = 0.0
        for ii in range(self.P):
            m = self.pta.model(ii)
            if m.fourier:
                start = min(s.cols.start for s in m.fourier)
                stop = max(s.cols.stop for s in m.fourier)
                phi = np.zeros(stop - start)
                for s in m.fourier:
                    phi[s.cols.start - start:s.cols.stop - start] += \
                        np.asarray(s.get_phi(params))
                bb = self.b[ii][start:stop]
                out += float(np.sum(-0.5 * np.log(phi)
                                    - 0.5 * bb * bb / phi))
            for s in m.chrom:
                phi = np.asarray(s.get_phi(params))
                bb = self.b[ii][s.cols]
                out += float(np.sum(-0.5 * np.log(phi)
                                    - 0.5 * bb * bb / phi))
        return out

    def lnlike_ecorr(self, xs):
        """b-conditional likelihood of all per-pulsar ECORR variances."""
        params = self.map_params(xs)
        out = 0.0
        for ii in range(self.P):
            if self.ecorr_sigs[ii] is None:
                continue
            phi = np.asarray(self.ecorr_sigs[ii].get_phi(params))
            bj = self.b[ii][self.ecid[ii]]
            out += float(np.sum(-0.5 * np.log(phi) - 0.5 * bj * bj / phi))
        return out

    def lnlike_fullmarg(self, xs):
        """Marginalized likelihood summed over pulsars (reference
        ``pta_gibbs.py:577-621``)."""
        params = self.map_params(xs)
        Nvecs = self.pta.get_ndiag(params)
        phis = self.pta.get_phi(params)
        out = 0.0
        for ii in range(self.P):
            out += -0.5 * (np.sum(np.log(Nvecs[ii]))
                           + np.sum(self._y[ii] ** 2 / Nvecs[ii]))
            if self._ke is not None and self._ke[ii] is not None:
                out += self._ke_corr_ii(params, Nvecs[ii], self._y[ii], ii)
            phi_ii = phis[ii][:self._T[ii].shape[1]]
            phiinv_ii, logdet_phi = 1.0 / phi_ii, np.sum(np.log(phi_ii))
            TNT, d = self._tnt_d_ii(params, Nvecs, ii)
            Sigma = TNT + np.diag(phiinv_ii)
            try:
                cf = sl.cho_factor(Sigma)
            except np.linalg.LinAlgError:
                return -np.inf
            expval = sl.cho_solve(cf, d)
            logdet_sigma = 2.0 * np.sum(np.log(np.diag(cf[0])))
            out += 0.5 * (d @ expval - logdet_sigma - logdet_phi)
        return float(out)

    # ---- conditional draws -------------------------------------------------

    def draw_b(self, xs):
        if self.G is not None:
            return self._draw_b_joint(xs)
        params = self.map_params(xs)
        Nvecs = self.pta.get_ndiag(params)
        phis = self.pta.get_phi(params)
        for ii in range(self.P):
            TNT, d = self._tnt_d_ii(params, Nvecs, ii)
            Sigma = TNT + np.diag(1.0 / phis[ii][:self._T[ii].shape[1]])
            u, s, _ = sl.svd(Sigma)
            mn = u @ ((u.T @ d) / s)
            Li = u * np.sqrt(1.0 / s)
            self.b[ii] = mn + Li @ self.rng.standard_normal(len(mn))
        return self.b

    def _draw_b_joint(self, xs):
        """Correlated-ORF joint b-draw: one dense Gaussian over all
        pulsars' coefficients.  The inter-pulsar coupling lives only in the
        GW columns, whose joint prior per (frequency, phase) group is
        ``rho_k G`` over pulsars, so ``Phi^-1`` is diagonal everywhere
        except those groups, which carry ``G^-1 / rho_k``."""
        params = self.map_params(xs)
        Nvecs = self.pta.get_ndiag(params)
        phis = self.pta.get_phi(params)
        offs = np.cumsum([0] + [T.shape[1] for T in self._T])
        nb = offs[-1]
        Sigma = np.zeros((nb, nb))
        phiinv_diag = np.zeros(nb)
        ds = []
        for ii in range(self.P):
            sl_ = slice(offs[ii], offs[ii + 1])
            TNT, d_ii = self._tnt_d_ii(params, Nvecs, ii)
            Sigma[sl_, sl_] = TNT
            ds.append(d_ii)
            pin = 1.0 / phis[ii][:self._T[ii].shape[1]]
            pin[self.gwid[ii]] = 0.0         # replaced by the group blocks
            phiinv_diag[sl_] = pin
        Sigma[np.diag_indices(nb)] += phiinv_diag
        rho = np.asarray(self.gw_sigs[0].get_phi(params))[::2]
        K = len(rho)
        Ginv = self._ginv(xs)
        for k in range(K):
            for phase in (0, 1):
                rows = np.array([offs[ii] + self.gwid[ii][2 * k + phase]
                                 for ii in range(self.P)])
                Sigma[np.ix_(rows, rows)] += Ginv[k] / rho[k]
        d = np.concatenate(ds)
        cf = sl.cho_factor(Sigma, lower=True)
        mn = sl.cho_solve(cf, d)
        z = self.rng.standard_normal(nb)
        samp = mn + sl.solve_triangular(cf[0], z, lower=True, trans=1)
        for ii in range(self.P):
            self.b[ii] = samp[offs[ii]:offs[ii + 1]]
        return self.b

    def _rho_log_pdf_grid(self, tau, other, grid):
        return rho_log_pdf_grid(tau, other, grid)

    def update_rho(self, xs):
        """Common free-spectrum draw: per-pulsar log-PDF grids summed across
        pulsars (== reference's PDF product, ``pta_gibbs.py:205``), then
        inverse-CDF sampled.

        With a correlated ORF the conditional generalizes to
        ``p(rho_k | a) ~ rho^-P exp(-taut_k / rho)`` with the quadratic
        form ``taut_k = 0.5 sum_phase a_k^T G^-1 a_k`` (which reduces to
        ``sum_p tau_pk`` at ``G = I``)."""
        xnew = xs.copy()
        params = self.map_params(xnew)
        K = len(self.idx.rho)
        grid = rho_grid(self.rhomin, self.rhomax)
        if self.G is not None:
            a = np.stack([self.b[ii][self.gwid[ii]] for ii in range(self.P)])
            taut = np.zeros(K)
            Ginv = self._ginv(xnew)
            for phase in (0, 1):
                ap = a[:, phase::2][:, :K]              # (P, K)
                taut += 0.5 * np.einsum("pk,kpq,qk->k", ap, Ginv, ap)
            logpdf = (-self.P * np.log(grid)[None, :]
                      - taut[:, None] / grid[None, :])
        else:
            logpdf = np.zeros((K, len(grid)))
            for ii in range(self.P):
                tau = self._gw_tau(ii)[:K]
                if self.red_sigs[ii] is not None and self._red_shares_gw[ii]:
                    other = align_phi(np.asarray(
                        self.red_sigs[ii].get_phi(params))[::2], K)
                else:
                    other = np.full(K, 1e-30)
                logpdf += self._rho_log_pdf_grid(tau, other, grid)
        # Gumbel-max across the grid == inverse-CDF on the discrete pdf
        xnew[self.idx.rho] = 0.5 * np.log10(
            gumbel_grid_draw(self.rng, logpdf, grid))
        return xnew

    def update_red(self, xs, adapt=False):
        """Per-pulsar intrinsic red *free-spectrum* block (reference
        ``pta_gibbs.py:252-276``): grid draw per pulsar with the common GW as
        the 'other' phi component.  No-op when there is no red rho block."""
        if len(self.idx.red_rho):
            xnew = xs.copy()
            params = self.map_params(xnew)
            grid = rho_grid(self.rhomin_red, self.rhomax_red)
            for ii in range(self.P):
                if self.red_sigs[ii] is None or not len(self.red_rho_idx[ii]):
                    continue
                K = len(self.red_rho_idx[ii])
                tau = self._red_tau(ii)[:K]
                # the gw 'other' variance applies only on SHARED columns
                # (CRN layout); a correlated common process lives on its
                # own columns, which carry no common variance
                if self._red_shares_gw[ii]:
                    gw = align_phi(
                        np.asarray(self.gw_sigs[ii].get_phi(params))[::2], K)
                else:
                    gw = np.full(K, 1e-30)
                logpdf = rho_log_pdf_grid(tau, gw, grid)
                # assignment keyed by this pulsar's own chain columns
                xnew[self.red_rho_idx[ii]] = 0.5 * np.log10(
                    gumbel_grid_draw(self.rng, logpdf, grid))
            return xnew
        return xs.copy()

    def _orf_G(self, xs):
        """(P, P) correlation matrix at the current sampled weights."""
        return np.eye(self.P) + np.einsum("j,jpq->pq", xs[self.orf_idx],
                                          self.orf_B)

    def _ginv(self, xs):
        """(K, P, P) inverse ORF stack at the current state."""
        if self.orf_B is None:
            return self.Ginv
        Gi = np.linalg.inv(self._orf_G(xs))
        return np.broadcast_to(Gi, (self._K, self.P, self.P))

    def update_orf(self, xs):
        """MH block for the sampled ORF weights (bin_orf / legendre_orf):
        single-site scale-mixture proposals on the coefficient-conditional
        correlated likelihood ``-K ln det G - 0.5 sum a^T G^-1 a / rho``;
        non-PD proposals are rejected (Cholesky failure -> -inf)."""
        if self.orf_B is None or not len(self.idx.orf):
            return xs.copy()

        a = np.stack([self.b[ii][self.gwid[ii]] for ii in range(self.P)])
        K = self._K

        def lnlike(q):
            G = self._orf_G(q)
            try:
                cf = sl.cho_factor(G, lower=True)
            except np.linalg.LinAlgError:
                return -np.inf
            except ValueError:
                return -np.inf
            logdet = 2.0 * np.sum(np.log(np.diag(cf[0])))
            rho = 10.0 ** (2.0 * q[self.idx.rho])
            quad = 0.0
            for phase in (0, 1):
                ap = a[:, phase::2][:, :K]              # (P, K)
                w = sl.cho_solve(cf, ap)
                quad += np.sum(ap * w / rho[None, :])
            return -K * logdet - 0.5 * quad

        return self._mh_loop(xs, self.idx.orf, lnlike, self.red_steps,
                             0.05 * len(self.idx.orf))

    def update_tprocess_alpha(self, xs):
        """Per-pulsar grid draw of t-process scale factors from the
        conditional including the shared common-process variance
        (see ``numpy_backend.NumpyGibbs.update_tprocess_alpha``)."""
        xnew = xs.copy()
        params = self.map_params(xnew)
        grid = 10.0 ** np.linspace(TP_ALPHA_LOG10_MIN, TP_ALPHA_LOG10_MAX,
                                   TP_ALPHA_GRID)
        for ii in range(self.P):
            sig = self.red_sigs[ii]
            if sig is None or not len(self.alpha_idx[ii]):
                continue
            bb = self.b[ii][self.redid[ii]] ** 2
            tau = 0.5 * (bb[::2] + bb[1::2])
            plaw = sig.powerlaw(params)[::2]
            if self._red_shares_gw[ii]:
                other = align_phi(
                    np.asarray(self.gw_sigs[ii].get_phi(params))[::2],
                    len(tau))
            else:
                other = np.full(len(tau), 1e-30)
            logpdf = tprocess_alpha_log_pdf_grid(tau, plaw, other, grid)
            xnew[self.alpha_idx[ii]] = gumbel_grid_draw(self.rng, logpdf,
                                                        grid)
        return xnew

    def update_red_mh(self, xs, adapt=False):
        """Powerlaw-family hyper block (per-pulsar red and/or a varied
        common process): adaptive MH as in the single-pulsar sampler."""
        rind = self.idx.red
        if not len(rind):
            return xs.copy()
        if adapt:
            rec = np.zeros((self.red_adapt_iters, len(rind)))
            xnew = self._mh_loop(xs, rind, self.lnlike_fullmarg,
                                 self.red_adapt_iters, 0.05 * len(rind), rec)
            burn = rec[min(100, len(rec) // 2):]
            self.cov_red = np.atleast_2d(np.cov(burn, rowvar=False))
            self.cov_red += 1e-12 * np.eye(len(rind))
            self._red_eigs = np.linalg.svd(self.cov_red)
            self.red_hist = seed_red_hist(burn)
            self._red_pend = self.red_hist.copy()
            self._red_count = 0
            return xnew
        x = xs.copy()
        ll0, lp0 = self.lnlike_red(x), self.get_lnprior(x)
        U, S, _ = self._red_eigs
        am_sqrt = U * np.sqrt(S)[None, :]
        for _ in range(self.red_steps):
            r = self.rng.uniform()
            if r < 0.5:
                q = de_step(self.rng, x, rind, self.red_hist)
            elif r < 0.65:
                q = x.copy()
                j = self.rng.integers(len(rind))
                q[rind] += 2.38 * np.sqrt(S[j]) * self.rng.standard_normal() * U[:, j]
            elif r < 0.8:
                # AM: full adapted-covariance jump (reference weight 15/95)
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

    @property
    def rhomin_red(self):
        return rho_bounds(self.pta, "red")[0]

    @property
    def rhomax_red(self):
        return rho_bounds(self.pta, "red")[1]

    def _mh_loop(self, xs, idx, lnlike, nsteps, sigma, record=None):
        x = xs.copy()
        ll0, lp0 = lnlike(x), self.get_lnprior(x)
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
        wind = self.idx.white
        sigma = 0.05 * len(wind)
        if adapt:
            rec = np.zeros((self.white_adapt_iters, len(wind)))
            xnew = self._mh_loop(xs, wind, self.lnlike_white,
                                 self.white_adapt_iters, sigma, rec)
            burn = rec[min(100, len(rec) // 2):]
            self.cov_white = np.atleast_2d(np.cov(burn, rowvar=False))
            self.aclength_white = int(max(
                1, max(int(integrated_act(burn[:, j])) for j in range(len(wind)))))
            return xnew
        return self._mh_loop(xs, wind, self.lnlike_white,
                             self.aclength_white, sigma)

    def update_ecorr(self, xs, adapt=False):
        eind = self.idx.ecorr
        sigma = 0.05 * len(eind)
        target = self.lnlike_white if self.kernel_ecorr else self.lnlike_ecorr
        if adapt:
            rec = np.zeros((self.white_adapt_iters, len(eind)))
            xnew = self._mh_loop(xs, eind, target,
                                 self.white_adapt_iters, sigma, rec)
            burn = rec[min(100, len(rec) // 2):]
            self.aclength_ecorr = int(max(
                1, max(int(integrated_act(burn[:, j])) for j in range(len(eind)))))
            return xnew
        return self._mh_loop(xs, eind, target,
                             self.aclength_ecorr, sigma)

    # ---- sweep -------------------------------------------------------------

    def sweep(self, xs, first=False):
        """Reference sweep order (``pta_gibbs.py:664-704``)."""
        x = np.asarray(xs, dtype=np.float64).copy()
        if first and self.orf_B is not None:
            wmin = float(np.linalg.eigvalsh(self._orf_G(x)).min())
            if wmin <= 1e-10:
                raise ValueError(
                    "initial ORF weights give a non-positive-definite "
                    f"correlation matrix (min eigenvalue {wmin:.2e}); "
                    "start the *_orfw_* parameters at 0 (G = identity)")
        if first:
            self.draw_b(x)
        self.invalidate_cache()
        if len(self.idx.white):
            x = self.update_white(x, adapt=first)
        if len(self.idx.ecorr) and (self.kernel_ecorr or any(
                s is not None for s in self.ecorr_sigs)):
            x = self.update_ecorr(x, adapt=first)
        if len(self.idx.red_rho):
            x = self.update_red(x, adapt=first)
        if any(len(a) for a in self.alpha_idx):
            x = self.update_tprocess_alpha(x)
        if len(self.idx.red):
            x = self.update_red_mh(x, adapt=first)
        if len(self.idx.rho):
            x = self.update_rho(x)
        if self.orf_B is not None and len(self.idx.orf):
            x = self.update_orf(x)
        self.draw_b(x)
        return x

    # ---- resume state ------------------------------------------------------

    def adapt_state(self):
        out = {"rng_state": rng_state_pack(self.rng)}
        for ii, b in enumerate(self.b):
            out[f"b{ii}"] = b
        for key in _STATE_KEYS:
            val = getattr(self, key, None)
            if val is not None:
                out[key] = np.asarray(val)
        return out

    def load_adapt_state(self, state):
        rng_state_unpack(self.rng, state["rng_state"])
        self.b = [np.asarray(state[f"b{ii}"]) for ii in range(self.P)]
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
