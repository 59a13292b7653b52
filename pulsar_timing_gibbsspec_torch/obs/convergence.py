"""Rank-normalized split-R-hat (Vehtari et al. 2021) on host arrays.

The port's copy of ``pulsar_timing_gibbsspec_tpu/obs/convergence.py``.
The moment sketch gives a streaming split-R-hat from the summary slab
(:func:`.summary.moment_split_rhat`); this module is the exact
rank-based estimator for a (thinned) record slab on the host: tests,
parity checks against the device sketch, :class:`.summary.RollingDiag`.
The normal quantile function is ``torch.special.ndtri`` on float64.
"""

from __future__ import annotations

import numpy as np
import torch


def _ndtri(p: np.ndarray) -> np.ndarray:
    return torch.special.ndtri(torch.as_tensor(
        np.asarray(p, np.float64))).numpy()


def _avg_ranks(a: np.ndarray) -> np.ndarray:
    """Average ranks (1-based, ties averaged) of the pooled flat array,
    returned in ``a``'s shape."""
    flat = a.ravel()
    order = np.argsort(flat, kind="stable")
    ranks = np.empty_like(flat)
    sv = flat[order]
    # tie groups share the mean of their would-be ranks
    boundaries = np.flatnonzero(np.r_[True, sv[1:] != sv[:-1], True])
    for lo, hi in zip(boundaries[:-1], boundaries[1:]):
        ranks[order[lo:hi]] = 0.5 * (lo + hi - 1) + 1.0
    return ranks.reshape(a.shape)


def rank_normalize(chains: np.ndarray) -> np.ndarray:
    """Pooled rank-normalization: ranks across ALL chains and draws,
    mapped through the normal quantile with the (r - 3/8)/(S + 1/4)
    blom offset (Vehtari et al. 2021, eq. 14)."""
    chains = np.asarray(chains, np.float64)
    S = chains.size
    return _ndtri((_avg_ranks(chains) - 0.375) / (S + 0.25))


def split_rhat(chains: np.ndarray) -> float:
    """Classic potential scale reduction on split chains.

    ``chains`` is ``(C, n)``; each chain is split into halves (2C
    groups of n//2 draws) before the between/within ratio, so a single
    drifting chain is detected even at C == 1.
    """
    chains = np.asarray(chains, np.float64)
    if chains.ndim != 2:
        raise ValueError("split_rhat expects (chains, draws)")
    n = chains.shape[1] // 2
    if n < 2:
        return 1.0
    halves = np.concatenate([chains[:, :n], chains[:, n:2 * n]], axis=0)
    W = halves.var(axis=1, ddof=1).mean()
    if W <= 0:
        return 1.0
    B = n * halves.mean(axis=1).var(ddof=1)
    var_plus = (n - 1.0) / n * W + B / n
    return float(np.sqrt(var_plus / W))


def rank_normalized_split_rhat(chains: np.ndarray) -> float:
    """max(bulk, tail) rank-based split-R-hat: the bulk statistic on
    rank-normalized draws, the tail statistic on the rank-normalized
    folded draws ``|x - median|``."""
    chains = np.asarray(chains, np.float64)
    bulk = split_rhat(rank_normalize(chains))
    folded = np.abs(chains - np.median(chains))
    tail = split_rhat(rank_normalize(folded))
    return max(bulk, tail)


def ensemble_rhat(chains: np.ndarray) -> np.ndarray:
    """Per-parameter rank-based split-R-hat over a ``(C, n, d)`` record
    slab (the 64-chain ensemble view the driver's thinned record
    provides)."""
    chains = np.asarray(chains, np.float64)
    if chains.ndim != 3:
        raise ValueError("ensemble_rhat expects (chains, draws, params)")
    return np.asarray([rank_normalized_split_rhat(chains[:, :, j])
                       for j in range(chains.shape[2])])
