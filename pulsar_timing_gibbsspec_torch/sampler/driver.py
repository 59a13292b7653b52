"""The CRN free-spectrum Gibbs driver, with the chains as a batch axis.

Port of the CRN path of ``pulsar_timing_gibbsspec_tpu/sampler/
jax_backend.py::JaxGibbsDriver``: an initial exact b-draw, ``W`` warmup
sweeps (``_warmup_body``), the first-sweep adaptation (``_first_sweep``:
Laplace proposals, a record scan, the moment-matched independence
proposal, the ACT that sizes the white sub-chain), then steady sweeps
(``_sweep_body``) in the JAX order

    white MH -> red conditional -> common rho -> rho <-> b scale moves
    -> Metropolised b-draw (``draw_b_mh``),

with the near-exact ``draw_b_refresh`` in place of ``draw_b_mh`` on every
iteration ``t`` with ``t % exact_every == 0``.  State is carried as
``(C, ...)`` tensors on the model's device and every block runs on all
chains at once, so the kernels see ``C * P`` systems; each chunk of
records is copied to the host once.  Randomness comes from one explicit
``torch.Generator`` seeded from ``seed``.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from ..config import settings
from ..ops.acf import integrated_act_columns
from . import blocks
from .blocks import EXACT_EVERY

#: single-site white MH steps per warmup sweep (before adaptation)
WARMUP_WHITE_STEPS = 16
#: cap on the ACT-sized white sub-chain of a steady sweep
WHITE_STEPS_MAX = 64


class BlockTimer:
    """Milliseconds spent per named block: CUDA events around each block
    on a card (read when :meth:`flush` synchronizes), the host clock on
    the CPU.  Each block is also a ``block:<name>`` range for
    ``torch.profiler``."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.ms = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self._pending = []

    @contextlib.contextmanager
    def __call__(self, name):
        self.calls[name] += 1
        with torch.profiler.record_function(f"block:{name}"):
            yield from self._time(name)

    def _time(self, name):
        if self.cuda:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            yield
            e.record()
            self._pending.append((name, s, e))
        else:
            t0 = time.perf_counter()
            yield
            self.ms[name] += 1e3 * (time.perf_counter() - t0)

    def flush(self):
        if self._pending:
            torch.cuda.synchronize()
            for name, s, e in self._pending:
                self.ms[name] += s.elapsed_time(e)
            self._pending.clear()


def _moment_proposal(rec, nper):
    """Moment-matched independence proposal from an adaptation record
    (C, steps, P, W): per-chain ``(mode, chol, asqrt)`` as float64 host
    arrays, pad rows falling back to unit factors."""
    rec = np.asarray(rec, np.float64)
    C, S, P, W = rec.shape
    burn = rec[:, min(100, S // 2):]
    mode = burn.mean(axis=1)
    dev = burn - mode[:, None]
    cov = np.einsum("cspw,cspv->cpwv", dev, dev) / max(burn.shape[1] - 1, 1)
    nper = np.asarray(nper)
    wmask = np.arange(W)[None] < nper[:, None]
    mo = wmask[:, :, None] & wmask[:, None, :]
    cov = np.where(mo[None], cov, 0.0) + np.where(
        wmask, 0.0, 1.0)[None, :, :, None] * np.eye(W)
    e, V = np.linalg.eigh(cov)
    e = np.maximum(e, 1e-12)
    chol = (V * np.sqrt(e)[..., None, :]) * mo[None]
    asqrt = (V / np.sqrt(e)[..., None, :]) * mo[None]
    return mode, chol, asqrt


def _act_from_rec(rec, nper, P_real, pct=95.0):
    """Per-sweep white sub-chain length: the ``pct``-th percentile
    (ceil) of the per-(chain, pulsar, parameter) integrated ACTs of the
    post-burn record (C, steps, P, W)."""
    rec = np.asarray(rec, dtype=np.float64)
    nper = np.asarray(nper)
    burn = rec[:, min(100, rec.shape[1] // 2):]
    cols = [burn[c, :, p, w] for c in range(rec.shape[0])
            for p in range(P_real) for w in range(int(nper[p]))]
    if not cols:
        return 1
    acts = integrated_act_columns(np.stack(cols, axis=1))
    return max(1, int(np.ceil(np.percentile(acts, pct))))


class TorchGibbsDriver:
    """Blocked Gibbs over ``nchains`` independent chains of the CRN
    free-spectrum model ``cm`` (a compiled model on its device)."""

    def __init__(self, cm, nchains=1, seed=0, warmup_sweeps=50,
                 white_adapt_iters=1000):
        if len(cm.idx.red):
            raise NotImplementedError(
                "powerlaw-family hyper MH blocks are not in the port yet")
        if len(cm.idx.ecorr):
            raise NotImplementedError("ECORR is not in the port yet")
        if not (cm.K and len(cm.rho_ix_x)):
            raise ValueError("the model has no sampled common free "
                             "spectrum (the port's CRN sweep needs one)")
        self.cm = cm
        self.C = int(nchains)
        if self.C < 1:
            raise ValueError("nchains must be >= 1")
        self.warmup_sweeps = int(warmup_sweeps)
        self.white_adapt_iters = int(white_adapt_iters)
        self.chunk_size = settings.chunk_size
        self.exact_every = EXACT_EVERY
        self.warmup_white_steps = WARMUP_WHITE_STEPS
        self.white_steps_max = WHITE_STEPS_MAX
        self.do_white = len(cm.idx.white) > 0
        self.do_red_conditional = bool((cm.red_rho_ix_x < cm.nx).any())
        self.gen = torch.Generator(device=cm.device)
        self.gen.manual_seed(int(seed))
        self.timer = BlockTimer(cm.device)
        #: block milliseconds of the warmup and adaptation (``timer.ms``
        #: then holds the steady sweeps alone)
        self.warmup_ms = {}
        self.aclength_white = None
        self.chol_white = self.mode_white = self.asqrt_white = None
        #: the state after the last run: x (C, nx) and b (C, P, Bmax)
        self.x = None
        self.b = torch.zeros((self.C, cm.P, cm.Bmax), dtype=cm.cdtype,
                             device=cm.device)
        #: per-(chain, pulsar) accepted steady Metropolised b-draws
        self.b_mh_accepts = torch.zeros((self.C, cm.P), dtype=torch.float64,
                                        device=cm.device)
        self.b_mh_sweeps = 0
        #: (chain, pulsar) Laplace factors of the warmup and adaptation
        #: that came out non-finite (their proposals are all rejected)
        self.laplace_nonfinite = torch.zeros((), dtype=torch.int64,
                                             device=cm.device)
        self.steady_sweeps = 0
        #: wall seconds of the steady phase (host clock; every chunk ends
        #: in the device-to-host copy of its records)
        self.steady_seconds = 0.0

    # ---- blocks ------------------------------------------------------------

    def _hyper(self, x, b, u):
        cm, tm = self.cm, self.timer
        if self.do_red_conditional:
            with tm("red"):
                x = blocks.red_conditional_update(cm, x, b, self.gen)
        with tm("rho"):
            x = blocks.rho_update(cm, x, b, self.gen)
        if blocks._rho_scale_applies(cm):
            with tm("scale"):
                x, b, u = blocks.rho_scale_moves(cm, x, b, u, self.gen)
        return x, b, u

    def _count_nonfinite(self, chol):
        self.laplace_nonfinite += (~torch.isfinite(chol)).any(-1).any(
            -1).sum()

    def _warmup_sweep(self, x, b, u):
        """Pre-adaptation sweep: Laplace random-walk white sub-chain at
        the current state, the hyper block, the Metropolised refresh."""
        cm, tm = self.cm, self.timer
        if self.do_white:
            with tm("white"):
                r = cm.y - u
                r2 = r * r
                _, chol, _ = blocks.laplace_newton_chol(
                    cm, x, lambda q: blocks.lnlike_white_per(cm, q, r2),
                    cm.white_par_ix, cm.white_nper, newton_iters=0)
                self._count_nonfinite(chol)
                x, _ = blocks.parallel_cov_mh_scan(
                    cm, x, self.gen, blocks.white_block_ll(cm, x, r, r2),
                    cm.white_par_ix, cm.white_nper, chol,
                    self.warmup_white_steps, record=False)
        x, b, u = self._hyper(x, b, u)
        with tm("b_refresh"):
            b, u, _ = blocks.draw_b_refresh(cm, x, b, u, self.gen)
        return x, b, u

    def _sweep(self, x, b, u, exact):
        """One steady sweep; ``exact`` selects the refresh b-draw."""
        cm, tm = self.cm, self.timer
        if self.do_white and self.aclength_white:
            with tm("white"):
                r = cm.y - u
                x, _ = blocks.parallel_cov_mh_scan(
                    cm, x, self.gen, blocks.white_block_ll(cm, x, r, r * r),
                    cm.white_par_ix, cm.white_nper, self.chol_white,
                    self.aclength_white, record=False, mode=self.mode_white,
                    asqrt=self.asqrt_white)
        x, b, u = self._hyper(x, b, u)
        if exact:
            with tm("b_refresh"):
                b, u, _ = blocks.draw_b_refresh(cm, x, b, u, self.gen)
        else:
            with tm("b_mh"):
                b, u, acc = blocks.draw_b_mh(cm, x, b, u, self.gen)
            self.b_mh_accepts += acc.to(torch.float64)
            self.b_mh_sweeps += 1
        return x, b, u

    def _first_sweep(self, x):
        """Adaptation: Laplace proposals at the white conditional mode, a
        record scan, the moment-matched proposal, a second record whose
        ACT fixes the steady white sub-chain length; then the red and
        rho draws and a fresh exact b."""
        cm = self.cm
        f32 = cm.dtype
        b = blocks.draw_b_fn(cm, x, self.gen, self.b)
        self.b = b
        if self.do_white:
            r2 = blocks.residual_sq(cm, b)
            x, chol, asq = blocks.laplace_newton_chol(
                cm, x, lambda q: blocks.lnlike_white_per(cm, q, r2),
                cm.white_par_ix, cm.white_nper)
            self._count_nonfinite(chol)
            safe = torch.clamp(cm.white_par_ix, max=cm.nx - 1)
            mode = x[..., safe]
            r = cm.y - blocks.b_matvec(cm, b)

            def record(x, chol, mode, asq):
                return blocks.parallel_cov_mh_scan(
                    cm, x, self.gen, blocks.white_block_ll(cm, x, r, r * r),
                    cm.white_par_ix, cm.white_nper, chol.to(f32),
                    self.white_adapt_iters, mode=mode.to(f32),
                    asqrt=asq.to(f32))

            def dev(a):
                return torch.as_tensor(a, dtype=f32, device=cm.device)

            x, rec2 = record(x, chol, mode, asq)
            m2, c2, a2 = _moment_proposal(rec2.cpu().numpy(),
                                          cm.white_nper.cpu().numpy())
            self.mode_white, self.chol_white, self.asqrt_white = (
                dev(m2), dev(c2), dev(a2))
            x, rec3 = record(x, self.chol_white, self.mode_white,
                             self.asqrt_white)
            self.aclength_white = min(
                _act_from_rec(rec3.cpu().numpy(),
                              cm.white_nper.cpu().numpy(), cm.P_real),
                self.white_steps_max)
        if self.do_red_conditional:
            x = blocks.red_conditional_update(cm, x, b, self.gen)
        x = blocks.rho_update(cm, x, b, self.gen)
        self.b = blocks.draw_b_fn(cm, x, self.gen, b)
        return x

    # ---- run ---------------------------------------------------------------

    def _x_in(self, x):
        cm = self.cm
        x = torch.as_tensor(x, dtype=cm.cdtype, device=cm.device)
        if x.dim() == 1:
            x = x.expand(self.C, cm.nx)
        if tuple(x.shape) != (self.C, cm.nx):
            raise ValueError(f"x0 has shape {tuple(x.shape)}; expected "
                             f"({cm.nx},) or ({self.C}, {cm.nx})")
        return x.clone()

    @staticmethod
    def _check_finite(rows, row0, what, b):
        """Raise on a non-finite record row, or on a non-finite ``b`` at
        the end of the rows (which no later draw would replace)."""
        bad = ~np.isfinite(rows)
        if bad.any():
            r = int(np.argwhere(bad)[0][0])
            raise FloatingPointError(
                f"non-finite {what} at chain row {row0 + r}")
        if not bool(torch.isfinite(b).all()):
            raise FloatingPointError(
                f"non-finite b after chain row {row0 + len(rows) - 1}")

    def run(self, x0, niter):
        """Sample ``niter`` rows from start ``x0`` ((nx,) or (C, nx)).
        Returns the record (niter, C, nx) as a float32 host array: rows
        ``0..W-1`` hold the pre-sweep warmup states, row ``W`` the
        post-warmup state, and row ``t > W`` the state entering steady
        iteration ``t``."""
        cm = self.cm
        niter = int(niter)
        if niter < 1:
            raise ValueError("niter must be >= 1")
        chain = np.empty((niter, self.C, cm.nx), np.float32)
        x = self._x_in(x0)
        self.b = blocks.draw_b_fn(cm, x, self.gen)
        b = self.b
        u = blocks.b_matvec(cm, b)
        W = min(self.warmup_sweeps, niter - 1)
        recs = []
        for _ in range(W):
            recs.append(x.to(torch.float32))
            x, b, u = self._warmup_sweep(x, b, u)
        recs.append(x.to(torch.float32))
        rows = torch.stack(recs).cpu().numpy()
        self._check_finite(rows, 0, "warmup state", b)
        chain[:W + 1] = rows
        self.timer.flush()
        self.b = b
        x = self._first_sweep(x)
        b = self.b
        self.timer.flush()
        self.warmup_ms = dict(self.timer.ms)
        self.timer.ms.clear()
        t = W + 1
        t0 = time.perf_counter()
        while t < niter:
            n = min(self.chunk_size, niter - t)
            # u = T b afresh at every chunk, as the JAX chunk does: the
            # scale moves update it incrementally in between
            u = blocks.b_matvec(cm, b)
            recs = []
            for it in range(t, t + n):
                recs.append(x.to(torch.float32))
                x, b, u = self._sweep(x, b, u,
                                      exact=it % self.exact_every == 0)
            rows = torch.stack(recs).cpu().numpy()
            self._check_finite(rows, t, "chain state", b)
            chain[t:t + n] = rows
            self.timer.flush()
            self.steady_sweeps += n
            t += n
        self.steady_seconds += time.perf_counter() - t0
        self.x, self.b = x, b
        return chain
