"""Host-side finalizers of the device sketch.

The port of ``pulsar_timing_gibbsspec_tpu/obs/summary.py``: NumPy on the
small sketch state brought to the host once (:mod:`.sketch`), and on the
cumulative moment snapshots the driver keeps at each writeback; no
chain-sized arrays, no device work.
"""

from __future__ import annotations

import time

import numpy as np

from ..ops.acf import act_from_rho, integrated_act
from .sketch import SketchSpec


def finalize(spec: SketchSpec, state, c: float = 5.0) -> dict:
    """Turn a host copy of the sketch state into diagnostics.

    Returns per-chain/channel arrays: ``mean``/``var`` ``(C, D)``,
    ``rho`` ``(C, D, L)``, ``act``/``ess`` ``(C, D)`` (ACT in SWEEP
    units — the sketch streams every sweep, before record thinning),
    ``cross_cov`` ``(C, Kc, Kc)``, ``move_rate`` per block group, and
    scalar roll-ups (``act_rho_med``, ``ess_total``).
    """
    n = float(np.asarray(state["n"]))
    C, D, L = state["mean"].shape[0], spec.D, spec.lags
    mean = np.asarray(state["mean"], np.float64)
    m2 = np.asarray(state["m2"], np.float64)
    out = {"n": n, "channels": list(spec.names),
           "groups": [nm for nm, _ in spec.groups]}
    if n < 4:
        out.update(mean=mean, var=np.zeros_like(mean),
                   act=np.ones((C, D)), ess=np.zeros((C, D)),
                   rho=np.zeros((C, D, L)), cross_cov=None,
                   move_rate={}, act_rho_med=1.0, ess_total=0.0,
                   window_saturated=False)
        return out
    var = m2 / max(n - 1.0, 1.0)
    # plug-in-mean autocovariance from the lagged-product sums;
    # gamma_0 reduces exactly to the biased m2/n the FFT estimator uses
    counts = np.maximum(n - np.arange(L, dtype=np.float64), 1.0)
    # the lagged sums are of x - shift (obs/sketch.py); a state without a
    # shift is the JAX sketch's, of raw x
    shift = np.asarray(state.get("shift", 0.0), np.float64)
    gamma = (np.asarray(state["lag"], np.float64) / counts
             - (mean - shift)[..., None] ** 2)
    g0 = gamma[..., :1]
    dead = g0[..., 0] <= 0                    # constant channels
    rho = np.where(dead[..., None], 0.0, gamma / np.where(g0 <= 0, 1.0, g0))
    rho[..., 0] = np.where(dead, 1.0, rho[..., 0])
    act = act_from_rho(rho, c=c)
    act = np.where(dead, 1.0, act)
    # a window that never qualified means L was too short for this
    # channel's tau — surface it instead of silently under-reporting
    tau = 2.0 * np.cumsum(rho, axis=-1) - 1.0
    saturated = ~np.any(np.arange(L) >= c * tau, axis=-1) & ~dead
    ess = np.where(dead, 0.0, n / act)
    out.update(mean=mean, var=var, rho=rho, act=act, ess=ess,
               cross_cov=(np.asarray(state["cross"], np.float64)
                          / max(n - 1.0, 1.0)) if spec.cross_k else None,
               window_saturated=bool(saturated.any()))
    moven = float(np.asarray(state["moven"]))
    move = np.asarray(state["move"], np.float64)
    out["move_rate"] = {
        nm: move[:, g] / max(moven, 1.0)
        for g, (nm, _) in enumerate(spec.groups)}
    # roll-ups: the rho block is the slow
    # direction, so its median ACT is the honest mixing scalar
    nrho = sum(1 for nm in spec.names if "rho" in nm and "gw" in nm)
    sl = slice(0, nrho) if nrho else slice(0, D)
    out["act_rho_med"] = float(np.median(act[:, sl]))
    out["ess_total"] = float(ess.sum())
    return out


def moment_split_rhat(snaps, final) -> np.ndarray | None:
    """Split-R-hat per channel from cumulative moment snapshots.

    ``snaps`` is the driver's per-writeback list of cumulative
    ``(n, mean, m2)`` host tuples; ``final`` the end-of-run host state.
    The snapshot nearest n/2 gives the first-half moments; the second
    half follows by Chan SUBTRACTION of the cumulative pair — so each
    chain contributes two groups (its halves) to the classic Gelman-
    Rubin between/within ratio, all from the summary slab, never from
    chains.  Returns ``(D,)`` R-hat per channel, or None when the run
    is too short to split.
    """
    nT = float(np.asarray(final["n"]))
    if not snaps or nT < 8:
        return None
    ns = np.asarray([s[0] for s in snaps])
    k = int(np.argmin(np.abs(ns - nT / 2.0)))
    n1, mean1, m21 = snaps[k]
    n1 = float(n1)
    n2 = nT - n1
    if n1 < 4 or n2 < 4:
        return None
    meanT = np.asarray(final["mean"], np.float64)
    m2T = np.asarray(final["m2"], np.float64)
    mean2 = (nT * meanT - n1 * mean1) / n2
    m22 = m2T - m21 - (mean2 - mean1) ** 2 * (n1 * n2 / nT)
    # 2C groups: per-chain halves.  Group sizes differ by at most one
    # snapshot granule; use their mean as the formula's n.
    means = np.concatenate([mean1, mean2], axis=0)      # (2C, D)
    vars_ = np.concatenate([m21 / max(n1 - 1.0, 1.0),
                            np.maximum(m22, 0.0) / max(n2 - 1.0, 1.0)],
                           axis=0)
    nbar = (n1 + n2) / 2.0
    W = vars_.mean(axis=0)
    B = nbar * means.var(axis=0, ddof=1)
    W = np.where(W <= 0, np.finfo(np.float64).tiny, W)
    var_plus = (nbar - 1.0) / nbar * W + B / nbar
    return np.sqrt(var_plus / W)


class RollingDiag:
    """Bounded live diagnostics of a stream of recorded rows (host-side).

    A caller feeds it thinned recorded rows of its diagnostic channels;
    it keeps only the last ``cap`` rows and answers three gauges:
    ``ess_per_sec`` (Sokal ACT over the window / observed row rate),
    ``rhat_max`` (rank-normalized split-R-hat of the window halves,
    :mod:`.convergence`) and ``accept_rate`` (consecutive-row movement
    fraction).
    """

    def __init__(self, cap: int = 512):
        self.cap = int(cap)
        self._rows: list = []
        self.n = 0
        self.t0 = None

    def observe(self, rows: np.ndarray, now: float | None = None) -> None:
        """``rows`` is ``(m, d)``: recorded sweeps x diagnostic
        channels."""
        now = time.monotonic() if now is None else now
        if self.t0 is None:
            self.t0 = now
        self._t = now
        rows = np.asarray(rows, np.float64)
        self.n += rows.shape[0]
        self._rows.extend(rows)
        del self._rows[: max(0, len(self._rows) - self.cap)]

    def _window(self) -> np.ndarray:
        return np.asarray(self._rows, np.float64)

    def row_rate(self) -> float:
        dt = (self._t - self.t0) if self.t0 is not None else 0.0
        return self.n / dt if dt > 0 else 0.0

    def act(self) -> float:
        w = self._window()
        if w.shape[0] < 8:
            return 1.0
        return float(np.median([integrated_act(w[:, j])
                                for j in range(w.shape[1])]))

    def ess_per_sec(self) -> float:
        return self.row_rate() / max(self.act(), 1.0)

    def rhat_max(self) -> float:
        w = self._window()
        if w.shape[0] < 16:
            return 1.0
        from .convergence import rank_normalized_split_rhat

        vals = [rank_normalized_split_rhat(w[None, :, j])
                for j in range(w.shape[1])]
        return float(np.max(vals))

    def accept_rate(self) -> float:
        w = self._window()
        if w.shape[0] < 2:
            return 0.0
        return float(np.mean(np.any(w[1:] != w[:-1], axis=-1)))
