"""Streaming diagnostic sketch of the chains, kept on the device.

The port of ``pulsar_timing_gibbsspec_tpu/obs/sketch.py``: everything
the host needs to finalize mean/variance, small-k cross-covariance, a
Sokal-windowed ACT/ESS per chain and channel, per-block move rates and
a moment-based split-R-hat, as a dict of float64 tensors of fixed, small
shapes, so convergence diagnostics never depend on shipping chains.

The driver folds the full-precision float64 carry of every steady sweep
into it (:func:`fold_`, one sweep at a time, captured as a CUDA graph
of its own on a card), before the sweep's blocks: the stream is the
pre-sweep states, as the JAX chunk's state stack is, whatever the
record's thinning (``record_every``) or rounding
(``record_precision``).  It draws no random numbers and writes nothing
into the carry, so chains with and without it are bitwise equal.

Estimators (exact streaming identities):

- moments: the Chan et al. pairwise update of ``(n, mean, M2)`` per
  (chain, channel), and the matching co-moment update for the first
  ``cross_k`` channels;
- ACF: lagged-product sums ``S_l = sum_{t=l}^{n-1} y_t y_{t-l}`` of the
  values shifted by a per-(chain, channel) constant, ``y = x - shift``,
  through an ``L``-sample tail window (zero before the stream, so every
  product with it is 0 and ``S_l`` has pair count ``n - l``); the host
  takes ``gamma_l = S_l / (n - l) - (mean - shift)^2``.  The JAX sketch
  sums raw products (``shift = 0``), and that plug-in estimator is not
  shift-invariant: where a channel's mean is many standard deviations
  from 0 (log10_rho ~ -7, sd ~ 0.3), ``mean x (window mean - stream
  mean)`` swamps the autocovariance and the ACT comes out 2-3x off the
  host's.  The driver sets ``shift`` to the first folded state
  (:func:`set_shift_`), which leaves the estimator's error at the
  O(sqrt(tau / n)) of a zero-mean stream; ``shift = 0`` is the JAX
  arithmetic bit for bit;
- move rates: per transition and block group, the mean over the group's
  parameters of a changed-value indicator (for an MH block a move is an
  acceptance).  Folded per sweep, every transition is counted; the JAX
  chunk fold counts a chunk's entry state against itself and skips the
  transition into it, so its rates read lower by one transition a
  chunk.

:func:`update` is the JAX function's fold of a whole stack ``xs``; one
sweep's fold is ``update`` with a stack of one, to the float64 rounding
of the merge order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: channel cap: diagnostics follow the science-critical blocks first
#: (common rho, then hypers); the cap keeps the state and the fold's cost
#: O(C * channels * lags), independent of nx
DEFAULT_CHANNELS = 32
DEFAULT_CROSS = 8
DEFAULT_LAGS = 64

_F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """What the sketch tracks: ``channels`` are positions into the flat
    state vector ``x``, ``groups`` the Gibbs blocks' index arrays the
    move-rate sums run over (non-empty blocks only)."""

    channels: np.ndarray        # (D,) int -> x
    names: tuple                # (D,) parameter names of the channels
    cross_k: int                # leading channels with full cross-cov
    lags: int                   # L, ACF window length
    groups: tuple               # ((name, (g,) int -> x), ...)

    @property
    def D(self) -> int:
        return int(self.channels.shape[0])

    @property
    def G(self) -> int:
        return len(self.groups)


def make_sketch_spec(cm, channels: int = DEFAULT_CHANNELS,
                     cross: int = DEFAULT_CROSS,
                     lags: int = DEFAULT_LAGS) -> SketchSpec:
    """The channel selection of a compiled model: the common
    free-spectrum rho block first (the slow direction), then the red and
    ORF hypers, then white and ECORR, cut at ``channels``."""
    idx = cm.idx
    order, seen = [], set()
    for block in (idx.rho, idx.red, idx.orf, idx.red_rho, idx.white,
                  idx.ecorr):
        for i in np.asarray(block).ravel():
            i = int(i)
            if i not in seen:
                seen.add(i)
                order.append(i)
    if not order:
        order = list(range(min(int(channels), int(cm.nx))))
    ch = np.asarray(order[: int(channels)], dtype=np.int64)
    names = tuple(cm.param_names[i] for i in ch)
    groups = tuple(
        (nm, np.asarray(g, dtype=np.int64))
        for nm, g in (("rho", idx.rho), ("red", idx.red),
                      ("red_rho", idx.red_rho), ("white", idx.white),
                      ("ecorr", idx.ecorr), ("orf", idx.orf))
        if len(np.asarray(g)))
    return SketchSpec(channels=ch, names=names,
                      cross_k=min(int(cross), len(ch)), lags=int(lags),
                      groups=groups)


def spec_index(spec: SketchSpec, device):
    """The spec's index arrays as tensors on ``device``: ``(channels,
    [group index, ...])``, made once, before any CUDA graph capture
    (a host copy cannot be captured)."""
    return (torch.as_tensor(spec.channels, device=device),
            [torch.as_tensor(g, device=device) for _, g in spec.groups])


def init_state(spec: SketchSpec, nchains: int, device="cpu") -> dict:
    """Zero sketch state (float64 tensors).  The zero tail window is
    what makes ``S_l`` exact at the stream head."""
    C, D, L, Kc, G = (int(nchains), spec.D, spec.lags, spec.cross_k,
                      spec.G)

    def z(*shape):
        return torch.zeros(shape, dtype=_F64, device=device)

    return {"n": z(), "mean": z(C, D), "m2": z(C, D), "cross": z(C, Kc, Kc),
            "lag": z(C, D, L), "tail": z(C, D, L), "move": z(C, G),
            "moven": z(), "shift": z(C, D)}


def state_bytes(spec: SketchSpec, nchains: int) -> int:
    """Bytes of the sketch state (the JAX state's and ``shift``)."""
    C, D, L, Kc, G = (int(nchains), spec.D, spec.lags, spec.cross_k,
                      spec.G)
    return 8 * (1 + C * D * 3 + C * Kc * Kc + C * D * L * 2 + C * G + 1)


def set_shift_(spec: SketchSpec, state, x, index=None):
    """Set the lagged sums' shift to the channels of ``x`` (C, nx), in
    place; before the first fold (the sums assume one shift)."""
    ch = (index[0] if index is not None
          else torch.as_tensor(spec.channels, device=x.device))
    state["shift"].copy_(x[:, ch])


def update(spec: SketchSpec, state, x0, xs, index=None):
    """Fold a stack of states into the sketch: ``x0`` the state before
    the stack's first (C, nx), ``xs`` the per-sweep states (n, C, nx).
    Returns the new state dict (the JAX function's arithmetic); ``index``
    is :func:`spec_index`'s, made here when None."""
    ch, gix = index if index is not None else spec_index(spec, xs.device)
    nc = int(xs.shape[0])
    z = xs[:, :, ch].to(_F64).movedim(0, -1)                  # (C, D, n)

    na = state["n"]
    nb = float(nc)
    tot = na + nb

    # Chan pairwise merge of (n, mean, M2); exact for na == 0 too
    cmean = z.mean(-1)
    cm2 = ((z - cmean[..., None]) ** 2).sum(-1)
    delta = cmean - state["mean"]
    mean = state["mean"] + delta * (nb / tot)
    m2 = state["m2"] + cm2 + delta ** 2 * (na * nb / tot)

    # co-moment merge over the leading cross_k channels
    Kc = spec.cross_k
    zc = z[:, :Kc] - cmean[:, :Kc, None]
    ccov = torch.einsum("cin,cjn->cij", zc, zc)
    dk = cmean[:, :Kc] - state["mean"][:, :Kc]
    cross = (state["cross"] + ccov
             + dk[:, :, None] * dk[:, None, :] * (na * nb / tot))

    # lagged-product sums of the shifted values across the stack's start:
    # with the tail window every pair is available exactly once; window s
    # of ``ext`` is ext[s : s + n], and lag l pairs ``cur`` with window
    # L - l
    L = spec.lags
    ext = torch.cat([state["tail"], z - state["shift"][..., None]],
                    dim=-1)                                  # (C, D, L+n)
    cur = ext[..., L:]
    seg = ext.unfold(-1, nc, 1).flip(-2)[..., :L, :]         # (C, D, L, n)
    lag = state["lag"] + (seg * cur[..., None, :]).sum(-1)
    tail = ext[..., -L:]

    # per-block move fractions over the stack's n transitions
    full = torch.cat([x0[None], xs], dim=0)
    changed = full[1:] != full[:-1]                          # (n, C, nx)
    if gix:
        move = state["move"] + torch.stack(
            [changed[:, :, g].to(_F64).mean(-1).sum(0) for g in gix], -1)
    else:
        move = state["move"]
    return {"n": tot, "mean": mean, "m2": m2, "cross": cross, "lag": lag,
            "tail": tail, "move": move, "moven": state["moven"] + nb,
            "shift": state["shift"]}


def fold_(spec: SketchSpec, state, x_prev, x, index=None):
    """One sweep's fold, in place: ``x`` (C, nx) the state entering the
    sweep, ``x_prev`` the one entering the sweep before (then set to
    ``x``).  Every tensor keeps its storage, so a CUDA graph can hold
    them."""
    new = update(spec, state, x_prev, x[None], index)
    for k, v in new.items():
        state[k].copy_(v)
    x_prev.copy_(x)
