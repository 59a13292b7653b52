"""Divergence sentinels: cheap health checks on the sampled chain.

The port's copy of ``pulsar_timing_gibbsspec_tpu/runtime/sentinels.py``,
three layers, cheapest first:

- :func:`chunk_health`: torch reductions on a chunk's device records
  (per chain: all finite, the fraction of recorded steps that moved, the
  common rho inside its prior), queued on the driver's stream after the
  chunk's sweeps and copied to the host with the records, so they cost
  no extra synchronization.
- :class:`SentinelMonitor`: the host's tracker of those reductions;
  acceptance-collapse and rho-bound warnings go to ``metrics.jsonl``, and
  ``stuck_chunks`` consecutive fully stuck chunks raise
  :class:`ChainDivergence`.
- :func:`check_rows`: the facade's check of newly recorded rows before
  they can reach a checkpoint.

Recovery is the supervisor's: a divergence rewinds to the last checkpoint
and replays; one that repeats at the same point on the deterministic
replay gets :func:`refold_checkpoint_key`, a new seed at the checkpoint,
so that the replay draws another stream.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from . import telemetry


class ChainDivergence(FloatingPointError):
    """A recorded stretch of chain failed a health check: ``row`` is the
    first offending recorded row (absolute), ``what`` a tag
    (``"nonfinite"``, ``"stuck_chain"``).  A ``FloatingPointError``, so
    the supervisor's ``divergence`` class holds both."""

    def __init__(self, msg, row=None, what=None):
        super().__init__(msg)
        self.row = row
        self.what = what


#: slack (x units, 0.5 log10 rho) past the prior bounds before a recorded
#: rho counts as a breach: grid end points land exactly on the bound
RHO_BOUND_TOL = 1e-6


def chunk_health(xs, bs, rho_ix=None, rho_lo=None, rho_hi=None):
    """Health reductions over a chunk's records: ``xs`` (n, C, nx), ``bs``
    (n, C, ...) (tensors, or arrays that ``torch.as_tensor`` takes).
    Returns per chain:

    - ``finite`` (C,) bool: every recorded value finite;
    - ``move_frac`` (C,) float32: the fraction of recorded steps where the
      state changed at all (1 for a single row);
    - ``rho_ok`` (C,) bool: every recorded ``xs[..., rho_ix]`` inside
      ``[rho_lo, rho_hi]`` +- :data:`RHO_BOUND_TOL` (all True without
      rho coordinates).

    Plain tensor operations on the records' device: no host sync."""
    import torch

    xs, bs = torch.as_tensor(xs), torch.as_tensor(bs)
    C = xs.shape[1]
    fin = (torch.isfinite(xs).all(dim=-1).all(dim=0)
           & torch.isfinite(bs).reshape(bs.shape[0], C, -1).all(
               dim=-1).all(dim=0))
    if xs.shape[0] > 1:
        moved = (xs[1:] != xs[:-1]).any(dim=-1).to(torch.float32).mean(
            dim=0)
    else:
        moved = torch.ones(C, dtype=torch.float32, device=xs.device)
    if rho_ix is None or len(rho_ix) == 0 or rho_lo is None or rho_hi is None:
        rho_ok = torch.ones(C, dtype=torch.bool, device=xs.device)
    else:
        rows = xs[:, :, torch.as_tensor(rho_ix, device=xs.device)]
        rho_ok = ((rows >= rho_lo - RHO_BOUND_TOL)
                  & (rows <= rho_hi + RHO_BOUND_TOL)).all(dim=-1).all(dim=0)
    return {"finite": fin, "move_frac": moved, "rho_ok": rho_ok}


class SentinelMonitor:
    """Per-chunk health across a run: below ``collapse_frac`` moved a
    chain is flagged acceptance-collapsed (a warning event); after
    ``stuck_chunks`` consecutive chunks with nothing moved,
    :class:`ChainDivergence` is raised."""

    def __init__(self, collapse_frac=0.02, stuck_chunks=3):
        self.collapse_frac = float(collapse_frac)
        self.stuck_chunks = int(stuck_chunks)
        self.events = []
        self.last = None
        self._streak = None

    def reset_run(self):
        """Forget the streaks at the start of a run or a retry."""
        self._streak = None

    def observe(self, health, it):
        """Fold one chunk's host health dict in; returns the new warning
        events (also appended to :attr:`events`)."""
        fin = np.atleast_1d(np.asarray(health["finite"]))
        mv = np.atleast_1d(np.asarray(health["move_frac"], np.float64))
        self.last = {"finite_frac": float(fin.mean()),
                     "move_frac_min": round(float(mv.min()), 4),
                     "move_frac_mean": round(float(mv.mean()), 4)}
        if self._streak is None or len(self._streak) != len(mv):
            self._streak = np.zeros(len(mv), dtype=int)
        stuck = mv <= 0.0
        self._streak = np.where(stuck, self._streak + 1, 0)
        events = []
        if "rho_ok" in health:
            rok = np.atleast_1d(np.asarray(health["rho_ok"]))
            self.last["rho_ok_frac"] = float(rok.mean())
            if not rok.all():
                telemetry.incr("rho_bound_breaches")
                events.append({"event": "rho_bound_breach", "iter": int(it),
                               "chains": np.where(~rok)[0].tolist()})
        low = (mv < self.collapse_frac) & ~stuck
        if low.any():
            events.append({"event": "mh_acceptance_collapse", "iter": int(it),
                           "chains": np.where(low)[0].tolist(),
                           "move_frac": [round(float(v), 4)
                                         for v in mv[low]]})
        if (self._streak >= self.stuck_chunks).any():
            chains = np.where(self._streak >= self.stuck_chunks)[0].tolist()
            telemetry.incr("sentinel_trips")
            raise ChainDivergence(
                f"chains {chains} recorded identical states for "
                f"{self.stuck_chunks} consecutive chunks (iteration "
                f"{it}): the sampler is wedged — rewind and re-draw",
                row=int(it), what="stuck_chain")
        if events:
            telemetry.incr("sentinel_events", len(events))
            self.events += events
        return events


def check_rows(chain, bchain, lo, hi):
    """Raise :class:`ChainDivergence` on a non-finite value in the newly
    recorded rows ``[lo, hi)``, naming the first bad row, before the rows
    can reach a checkpoint."""
    if hi <= lo:
        return
    for nm, arr in (("chain", chain), ("bchain", bchain)):
        seg = np.asarray(arr[lo:hi])
        if seg.size == 0:
            continue
        bad = ~np.isfinite(seg.reshape(len(seg), -1)).all(axis=1)
        if bad.any():
            row = lo + int(np.argmax(bad))
            telemetry.incr("sentinel_trips")
            raise ChainDivergence(
                f"non-finite {nm} state recorded at row {row}: the sweep "
                "diverged — rows past the last checkpoint are discarded",
                row=row, what="nonfinite")


def refold_checkpoint_key(outdir, salt) -> bool:
    """Give the checkpoint in ``outdir`` a new stream seed, perturbed by
    ``salt``, and bring the manifest up to date (both atomically).

    The port's streams are pure in ``(seed, iteration)``
    (``driver.stream_seed``); ``adapt.npz`` holds the seed, which becomes
    ``driver.refold_seed(seed, salt)``.  The replay from the checkpoint
    then draws another stream, by design no longer the uninterrupted
    run's.  Returns False when there is no port checkpoint to refold."""
    from ..sampler.driver import refold_seed

    apath = Path(outdir) / "adapt.npz"
    if not apath.exists():
        return False
    with np.load(apath) as z:
        state = {k: z[k] for k in z.files}
    if "seed" not in state:
        return False
    state["seed"] = np.uint64(refold_seed(int(state["seed"]), int(salt)))
    it = state.pop("iter")
    tmp = apath.with_name("adapt.npz.tmp.npz")
    np.savez(tmp, iter=it, **state)
    os.replace(tmp, apath)
    # the manifest holds adapt.npz's hash: rewrite it (same rows, its
    # layout sections kept) or the refolded set would fail verification
    from . import integrity

    man = integrity.read_manifest(outdir)
    if man is not None and not man.get("corrupt"):
        extra = {k: v for k, v in man.items()
                 if k not in ("schema", "rows", "written_at", "files")}
        integrity.write_manifest(outdir, man.get("rows", int(it)),
                                 extra=extra or None)
    telemetry.incr("refolds")
    return True
