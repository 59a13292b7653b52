"""The Gibbs driver, with the chains as a batch axis.

Port of ``pulsar_timing_gibbsspec_tpu/sampler/jax_backend.py::
JaxGibbsDriver`` for the port's models, one pulsar or an array: an initial
exact b-draw, ``W`` warmup sweeps (``_warmup_body``), the first-sweep
adaptation (``_first_sweep``: for the white block and, with basis ECORR,
the ECORR block, Laplace proposals, a record scan, the moment-matched
independence proposal and the ACT that sizes the block's sub-chain; for
the powerlaw hypers, an MH scan on the b-marginalized likelihood whose
record gives the proposal covariance and seeds the DE history), then
steady sweeps (``_sweep_body``) in the JAX order

    white MH -> ECORR MH -> free-spectrum red conditional (or the
    t-process alpha draw, ``tprocess``) -> powerlaw hyper MH
    (``red_mh``) -> common rho (grid draw, or the inverse-CDF draw of a
    single pulsar without red noise) -> rho <-> b scale moves -> sampled
    ORF weights' MH (``orf_mh``) -> Metropolised b-draw (``draw_b_mh``),

each block present only where the model samples parameters in it (fixed
white noise from a noise dictionary has no white block, constant ECORR
variances no ECORR block: not in the warmup, the adaptation, the sweep,
the graphs or ``adapt.npz``, as the JAX driver gates them), with the
near-exact ``draw_b_refresh`` in place of ``draw_b_mh`` on every
iteration ``t`` with ``t % exact_every == 0``.  Under a correlated ORF
(Hellings-Downs) there are no scale moves, and the b-draw is the
structured joint draw over all pulsars (``b_joint``: two-float factors
when ``joint_mixed``), in float64 on every ``exact_every``-th iteration
(``b_joint_exact``), in the warmup and in the initial draws; past
``blocks.HD_DENSE_MAX`` coefficients ``PTGIBBS_HD_KERNEL=pulsar`` or
``freq`` (read when the driver is built) puts the pulsar-wise or the
frequency-block sweep in its place, two-float in ``b_joint`` and float64
elsewhere.  Sampled ORF weights (``bin_orf``, ``legendre_orf``) get a
single-site MH block of ``red_steps`` steps on their b-conditional
likelihood (``orf_mh``, warmup included); a start whose weights give a
non-positive-definite G raises ``ValueError``.  Under
kernel ECORR (``cm.has_ke``: ECORR inside N) there are no scale moves,
the ECORR block's target is the Woodbury conditional on the residual,
and every sweep, warmup included, takes the exact float64 b-draw
(``b_exact``): the Metropolised draws' accept density assumes diagonal
N, so the steady sweep is one body (``exact_every`` is 1).  State is
carried as ``(C, ...)`` tensors on the model's device and every block
runs on all chains at once, so the kernels see ``C * P`` systems.
``PTGIBBS_RHO_COLLAPSE=1`` (read when the driver is built) takes the
partially collapsed common-rho draw on a CRN model whose sampled
free-spectrum red shares the common columns, and puts rho before the red
blocks in the warmup and steady sweeps (the adaptation sweep keeps the
order above), as the JAX sweep bodies do; a checkpoint records it, and a
resume under the other setting raises.

**Random streams.**  One ``torch.Generator`` is re-seeded at the start
of every sweep with :func:`stream_seed` of ``(seed, t)``, ``t`` the
absolute iteration index (warmup sweeps ``0..W-1``, the adaptation sweep,
then the steady sweeps); the initial exact b-draw has the stream
``t = INIT_STREAM``.  A sweep's draws depend on nothing else: the port's
form of the JAX ``fold_in(base_key, iteration)``.  So a resumed run
replays the uninterrupted one bitwise, and a CUDA graph replayed after
the re-seed draws what the eager sweep draws.  The CPU generator
(mt19937) and the CUDA one (Philox) give different streams for one seed.

**DE history.**  The powerlaw block's differential-evolution jumps read
a frozen (C, DE_HIST_LEN, d) buffer: for the iterations of DE period
``m`` (``[m DE_Q, (m+1) DE_Q)``) the chain rows ``[m DE_Q - DE_DELAY -
DE_HIST_LEN, m DE_Q - DE_DELAY)``, read from the host record by
iteration index, or the adaptation's seed rows until that window exists.
What a sweep sees is a function of its iteration alone, so resume and
graph replay stay bitwise.  The buffer is one device tensor that the
host refills in place between sweeps when the period changes.

**Steady loop.**  Steady sweeps run in chunks of ``chunk_size`` on a
grid anchored at the first steady iteration, so every checkpoint lands
on a chunk boundary and a resumed run replays the same grid; ``u = T b``
is recomputed at each chunk start, as the JAX chunk does.  On a card the
steady sweep replays CUDA graphs, one per block (:mod:`.graphs`), and
the records are double-buffered: chunk i+1 is queued before chunk i's
records are copied (pinned host buffers, a copy stream) and written
back.  :meth:`TorchGibbsDriver.run` is a generator over recorded row
counts that fills caller-owned ``chain``/``bchain`` arrays in the JAX
row layout (``record_every`` thinning, chains axis dropped at C = 1).

**Records.**  Recorded rows, x and b alike, are rounded to the record
dtype on the card (``record_precision``: ``"f32"``, the default, or
``"bf16"``; ``PTGIBBS_RECORD``), as the JAX chunk records them; the
post-warmup row, the carry and ``adapt.npz`` stay exact, so the sampled
process does not depend on it (but for the DE history, which reads the
recorded rows).

**Ensemble stage and sketch** (``ensemble``, ``pt_ladder``, ``obs``;
the JAX driver's ``ens_step`` and obs chunk): with the stage on, each
steady sweep is followed by :mod:`.ensemble`'s ASIS redraw, stretch
move and, under tempering, the swap of the sweep's parity, drawing from
the sweep's stream after its blocks; the ladder and counters live on the
device and reach the checkpoint at each writeback.  With ``obs`` each
steady sweep starts with the sketch's fold of the pre-sweep carry
(:mod:`..obs.sketch`).  Off, neither enters the sweep.  The run loop's
seams are :mod:`..obs.trace` spans with the JAX driver's names.

**Sharding** (a model shard of :func:`..parallel.sharding.
shard_compiled`): the carries hold this rank's chains (``Cl`` from
``c0``) and pulsars (``cm.pn`` from ``cm.p0``); every block draws its
noise at the logical shape and keeps its rows, the blocks that write
per-pulsar slots of ``x`` (white, ECORR, red) end with
:func:`..parallel.sharding.sync_x`, and the records, the carry at each
writeback and the adaptation's records are assembled on the host into
the logical arrays on every rank, so the checkpoint state
(:meth:`TorchGibbsDriver.adapt_state`) is the unsharded run's layout.
Under gloo the steady sweep runs eagerly (:attr:`TorchGibbsDriver.
graphs_off`).

**Resilience** (the JAX driver's, ``runtime``): per chunk, the
sentinels' :func:`..runtime.sentinels.chunk_health` runs on the chunk's
device records and reaches the host with them (``sentinels=True``);
the ``dispatch.chunk`` fault seam fires once a chunk is queued, and with
a ``watchdog`` the seam and the host's wait for the previous chunk run
under its deadline (the chunks are queued on this thread only); once a
preemption drain is requested no chunk is queued, and the chunk in
flight is written back, or dropped when landing it would blow the
deadline.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from ..config import (current_settings, ensemble_choice, hd_kernel_choice,
                      record_dtype, rho_collapse_choice)
from ..obs import trace as otrace
from ..ops.acf import integrated_act_columns
from ..parallel import sharding
from ..runtime import faults, preemption, telemetry
from ..runtime.sentinels import ChainDivergence, SentinelMonitor, chunk_health
from ..runtime.watchdog import DispatchWatchdog
from . import blocks
from . import ensemble as ens_mod
from .blocks import EXACT_EVERY
from .graphs import SteadyGraphs

#: single-site white MH steps per warmup sweep (before adaptation)
WARMUP_WHITE_STEPS = 16
#: cap on the ACT-sized white (and ECORR) sub-chain of a steady sweep
WHITE_STEPS_MAX = 64
#: stream index of the initial exact b-draw
INIT_STREAM = -1
#: rows of the DE history; its refresh period and chain-row delay, in
#: iterations (a chunk may not outrun the delay: chunk_size <= DE_DELAY -
#: DE_Q)
DE_HIST_LEN, DE_Q, DE_DELAY = 64, 128, 256
_MASK64 = (1 << 64) - 1


def _splitmix64(z):
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def stream_seed(seed, t):
    """64-bit generator seed of iteration ``t``'s stream:
    ``splitmix64(splitmix64(seed) ^ t)`` on 64-bit words."""
    return _splitmix64(_splitmix64(int(seed) & _MASK64) ^ (int(t) & _MASK64))


#: the blocks whose likelihood a tempered chain raises to its beta
TEMPERED_BLOCKS = frozenset(("white", "ecorr", "scale", "b_mh", "b_refresh",
                             "asis"))

#: the reserved stream index a refolded seed is drawn from (no sweep
#: uses it: sweeps are ``t >= 0``, the initial draw ``INIT_STREAM``)
REFOLD_STREAM = -2


def refold_seed(seed, salt):
    """The seed a divergence refold gives a checkpoint:
    ``stream_seed(stream_seed(seed, REFOLD_STREAM), salt)``."""
    return stream_seed(stream_seed(seed, REFOLD_STREAM), salt)


#: the stream rule, as the checkpoint's layout section records it
RNG_RULE = ("torch.Generator re-seeded per sweep with splitmix64("
            "splitmix64(seed) ^ t), t the iteration (-1: initial exact b); "
            "CPU mt19937 and CUDA Philox streams differ")


class BlockTimer:
    """Milliseconds spent per named block: CUDA events around each block
    on a card (read when :meth:`flush` waits for them), the host clock on
    the CPU.  Each block is also a ``block:<name>`` range for
    ``torch.profiler``."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.ms = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self._pending = collections.deque()
        #: events recorded so far (a mark for :meth:`flush`)
        self.recorded = 0

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
            self.recorded += 1
        else:
            t0 = time.perf_counter()
            yield
            self.ms[name] += 1e3 * (time.perf_counter() - t0)

    def discard(self):
        """Drop the blocks still pending (those of a failed run)."""
        self._pending.clear()

    def flush(self, upto=None):
        """Add the pending blocks' times, the first ``upto - (recorded -
        pending)`` of them when ``upto`` (an earlier :attr:`recorded`) is
        given, waiting for each block's end."""
        n = len(self._pending)
        if upto is not None:
            n -= self.recorded - upto
        for _ in range(max(n, 0)):
            name, s, e = self._pending.popleft()
            e.synchronize()
            self.ms[name] += s.elapsed_time(e)


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


def red_adaptation(rec):
    """The powerlaw block's adaptation from its MH record (C, steps, d):
    per chain the post-burn covariance plus 1e-12 I, its SVD ``(U, S)``,
    and the seed DE history of ``DE_HIST_LEN`` rows spread over the
    post-burn record.  Returns ``(cov, U, S, hist)``, float64 host
    arrays."""
    rec = np.asarray(rec, dtype=np.float64)
    C, n, d = rec.shape
    burn0 = min(100, n // 2)
    cov = np.stack([np.atleast_2d(np.cov(rec[c, burn0:], rowvar=False))
                    + 1e-12 * np.eye(d) for c in range(C)])
    U, S, _ = np.linalg.svd(cov)
    take = np.linspace(burn0, n - 1, DE_HIST_LEN).astype(int)
    return cov, U, S, rec[:, take, :]


class _Carry:
    """The eager steady carry ``(x, b, u)`` and its sweep
    (:class:`.graphs.SteadyGraphs` is the graphed one)."""

    graphed = False

    def __init__(self, drv, x, b):
        self.drv, self.x, self.b, self.u = drv, x, b, None

    def reset_u(self):
        """``u = T b`` afresh."""
        self.u = blocks.b_matvec(self.drv.cm, self.b)

    def sweep(self, exact, t):
        self.x, self.b, self.u = self.drv._sweep(self.x, self.b, self.u,
                                                 exact, t)


class _Records:
    """Record rows of one steady chunk on the device (in the record dtype),
    its end-of-chunk carry and health reductions, and (on a card) pinned
    host twins filled by a copy stream."""

    def __init__(self, drv, rows):
        cm, C = drv.cm, drv.Cl
        dev = cm.device
        cdt = cm.cdtype
        self.dev = dict(
            xs=torch.empty((rows, C, cm.nx), dtype=drv.rdtype, device=dev),
            bs=torch.empty((rows, C, drv.nb_local), dtype=drv.rdtype,
                           device=dev),
            x_end=torch.empty((C, cm.nx), dtype=cdt, device=dev),
            b_end=torch.empty((C, cm.pn, cm.Bmax), dtype=cdt, device=dev),
            acc=torch.empty((C, cm.pn), dtype=torch.float64, device=dev),
            finite=torch.empty(C, dtype=torch.bool, device=dev),
            move_frac=torch.empty(C, dtype=torch.float32, device=dev),
            rho_ok=torch.empty(C, dtype=torch.bool, device=dev))
        #: the ensemble state and the sketch's moments at the chunk's end
        #: (the checkpoint's ``ens_*`` keys, the split-R-hat trail)
        self.extra = drv.chunk_extras()
        for k, v in self.extra.items():
            self.dev[k] = torch.empty_like(v)
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.host = {k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=True)
                         for k, v in self.dev.items()}
            self.copied = torch.cuda.Event()
            self._streamed = False
        else:
            self.host = self.dev
        #: what the writeback needs: first row, rows, iteration after the
        #: chunk, b_mh sweeps after it, the timer's mark
        self.meta = None

    def begin(self):
        """Hold the main stream until this buffer's last copy is done."""
        if self.cuda:
            torch.cuda.current_stream().wait_event(self.copied)

    def end(self, carry, acc, copy_stream, health_args):
        """Queue the carry's copy and the chunk's health reductions (on
        the current stream, after its sweeps), then the copy to the
        host."""
        d = self.dev
        m = self.meta[1]
        d["x_end"].copy_(carry.x)
        d["b_end"].copy_(carry.b)
        d["acc"].copy_(acc)
        for k, v in self.extra.items():
            d[k].copy_(v)
        if health_args is not None:
            for k, v in chunk_health(d["xs"][:m], d["bs"][:m],
                                     *health_args).items():
                d[k].copy_(v)
        if self.cuda:
            if not self._streamed:
                # freed with a copy in flight (a failed run), the buffers
                # wait for the copy stream before their memory is reused
                for v in d.values():
                    v.record_stream(copy_stream)
                self._streamed = True
            copy_stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(copy_stream):
                for k, v in self.host.items():
                    if k in ("xs", "bs"):
                        v[:m].copy_(d[k][:m], non_blocking=True)
                    else:
                        v.copy_(d[k], non_blocking=True)
                self.copied.record(copy_stream)

    def ready(self):
        """True once the copy to the host is done (no wait)."""
        return not self.cuda or self.copied.query()

    def read(self):
        """Host numpy copies of the chunk's rows (float64), carry,
        health and extras (waits for the copy)."""
        if self.cuda:
            self.copied.synchronize()
        m = self.meta[1]
        h = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
             for k, v in self.host.items()}
        health = {k: h[k].copy() for k in ("finite", "move_frac", "rho_ok")}
        extra = {k: h[k].copy() for k in self.extra}
        return (h["xs"][:m].astype(np.float64),
                h["bs"][:m].astype(np.float64), h["x_end"].copy(),
                h["b_end"].copy(), h["acc"].copy(), health, extra)


class TorchGibbsDriver:
    """Blocked Gibbs over ``nchains`` independent chains of the model
    ``cm`` (a compiled model on its device: a free-spectrum or
    powerlaw-family common process, or a common free spectrum under a
    fixed correlated ORF; sampled or fixed white noise and basis or
    kernel ECORR, free-spectrum, powerlaw, t-process or infinitepower
    intrinsic red noise, chromatic GPs and static marginalized columns
    optional).

    ``graphs`` (default: on when ``cm`` lives on a card) replays the
    steady sweep from CUDA graphs; ``graphs=False`` runs it eagerly, the
    check of the graphs against the eager sweep.  ``joint_mixed`` (None:
    ``PTGIBBS_JOINT_MIXED``, read when the driver is built) selects the
    two-float factors of a correlated ORF's steady joint b-draw; False
    keeps float64.

    The JAX driver's sweep options: ``exact_every`` (the near-exact
    refresh b-draw on every ``exact_every``-th sweep; 1 under kernel
    ECORR), ``white_steps_max`` (the cap on the ACT-sized white and
    ECORR sub-chains), ``warmup_white_steps`` (their length in a warmup
    sweep) and ``common_rho`` (True asserts that the model has a shared
    free-spectrum common block, as ``PTABlockGibbs`` does; a model
    without one raises ``ValueError``).  The first three change the
    stream, so a checkpoint records them and a resume with other values
    raises; so does a correlated ORF's b-draw (:attr:`hd_kernel`).

    And its run-time options: ``record_precision`` (``"f32"`` or
    ``"bf16"``, None: ``PTGIBBS_RECORD``), ``sentinels`` (the per-chunk
    health reductions and their :class:`..runtime.sentinels.
    SentinelMonitor`) and ``watchdog`` (True: a default
    :class:`..runtime.watchdog.DispatchWatchdog`; an instance is used as
    it is; None or False: no guard).

    And its ensemble and diagnostic options: ``ensemble`` (None:
    ``PTGIBBS_ENSEMBLE``) appends the stage of :mod:`.ensemble` (ASIS,
    stretch, with ``pt_ladder`` > 1 (None: ``PTGIBBS_PT_LADDER``) the
    tempering swaps) to every steady sweep, after its blocks; a model
    outside :func:`.ensemble.ensemble_applies`, a chain count the ladder
    does not tile and ``pt_ladder > 1`` without the stage raise
    ``ValueError``.  Under tempering, chain ``c`` runs at
    ``betas[c % pt_ladder]`` (computed on the device from the ladder's
    state in every block that needs it); only ``c % pt_ladder == 0`` are
    posterior samples.  ``obs`` (True, or a dict of
    :func:`..obs.sketch.make_sketch_spec` options) folds the carry of
    every steady sweep into the device sketch of :mod:`..obs.sketch`;
    :meth:`obs_summary` finalizes it."""

    def __init__(self, cm, nchains=1, seed=0, warmup_sweeps=50,
                 white_adapt_iters=1000, red_adapt_iters=2000, red_steps=20,
                 record_every=1, chunk_size=100, graphs=None,
                 joint_mixed=None, exact_every=EXACT_EVERY,
                 white_steps_max=WHITE_STEPS_MAX,
                 warmup_white_steps=WARMUP_WHITE_STEPS, common_rho=False,
                 record_precision=None, sentinels=True, watchdog=None,
                 obs=None, ensemble=None, pt_ladder=None):
        self.C = int(nchains)
        if self.C < 1:
            raise ValueError("nchains must be >= 1")
        #: the model's shard of a mesh (None on one model), with this
        #: driver's chains; ``Cl`` chains live here, from ``c0``
        self.shard = None
        self.Cl, self.c0 = self.C, 0
        if cm.shard is not None:
            sharding.validate_chains(cm.shard.mesh, self.C)
            self.shard = cm.shard.with_chains(self.C)
            cm = dataclasses.replace(cm, shard=self.shard)
            self.Cl, self.c0 = self.shard.cn, self.shard.c0
        self.cm = cm
        if common_rho and not (cm.K and len(cm.rho_ix_x)):
            raise ValueError(
                "common_rho=True but the model has no shared free-spectrum "
                "gw block (build with common_psd='spectrum')")
        self.seed = int(seed)
        self.warmup_sweeps = int(warmup_sweeps)
        self.white_adapt_iters = int(white_adapt_iters)
        self.chunk_size = int(chunk_size)
        self.record_every = int(record_every)
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if self.record_every < 1:
            raise ValueError("record_every must be >= 1")
        if self.chunk_size % self.record_every:
            raise ValueError(
                f"record_every={self.record_every} must divide "
                f"chunk_size={self.chunk_size}")
        self.red_adapt_iters = int(red_adapt_iters)
        self.red_steps = int(red_steps)
        self.do_red_mh = len(cm.idx.red) > 0
        if self.do_red_mh and self.record_every > 1:
            raise ValueError(
                "record_every > 1 is unavailable for models with a "
                "red-hyper MH block: the DE jump history reads recorded "
                "chain rows by iteration index; run with record_every=1")
        if self.do_red_mh and self.chunk_size > DE_DELAY - DE_Q:
            raise ValueError(
                f"chunk_size={self.chunk_size} exceeds the DE history "
                f"delay margin ({DE_DELAY - DE_Q}); use chunk_size <= "
                f"{DE_DELAY - DE_Q} for models with a red hyper MH block")
        #: dtype of the recorded rows (x and b)
        self.rdtype = record_dtype(record_precision)
        if watchdog is True:
            self.watchdog = DispatchWatchdog()
        elif isinstance(watchdog, DispatchWatchdog):
            self.watchdog = watchdog
        elif watchdog in (None, False):
            self.watchdog = None
        else:
            raise ValueError(
                "watchdog must be True/False/None or a DispatchWatchdog "
                f"instance, got {watchdog!r}")
        #: the per-chunk health monitor, and its last summary
        self.sentinel = SentinelMonitor() if sentinels else None
        self.health_last = None
        on_card = cm.device.type == "cuda"
        self.graphs = on_card if graphs is None else bool(graphs)
        if self.graphs and not on_card:
            raise ValueError("CUDA graphs need a model on a cuda device")
        #: why the steady sweep runs eagerly on a card, when it does
        self.graphs_off = None
        if (self.graphs and self.shard is not None
                and self.shard.mesh.group_backend(
                    self.shard.mesh.pulsar_group) == "gloo"):
            # gloo's collectives run on the host: a graph cannot hold them
            self.graphs = False
            self.graphs_off = "gloo"
        self.exact_every = int(exact_every)
        self.warmup_white_steps = int(warmup_white_steps)
        self.white_steps_max = int(white_steps_max)
        if min(self.exact_every, self.warmup_white_steps,
               self.white_steps_max) < 1:
            raise ValueError("exact_every, warmup_white_steps and "
                             "white_steps_max must be >= 1")
        self.do_white = len(cm.idx.white) > 0
        self.do_ecorr = len(cm.idx.ecorr) > 0 and (cm.ec_cols.shape[1] > 0
                                                   or cm.has_ke)
        #: the t-process alphas' conjugate grid draw, in place of the
        #: free-spectrum red conditional
        self.do_tprocess = (cm.red_kind == "tprocess"
                            and bool((cm.red_rho_ix_x < cm.nx).any()))
        self.do_red_conditional = (not self.do_tprocess and bool(
            (cm.red_rho_ix_x < cm.nx).any()))
        if cm.has_ke:
            # one steady body: the exact b-draw on every sweep
            self.exact_every = 1
        self.do_rho = bool(cm.K and len(cm.rho_ix_x))
        #: the partially collapsed common-rho draw
        #: (``PTGIBBS_RHO_COLLAPSE=1``, read here, where the model has a
        #: sampled free-spectrum red on the common columns): rho is drawn
        #: with red integrated out and comes before the red draw in the
        #: warmup and steady sweeps
        self.rho_collapse = self.do_rho and blocks._rho_collapsed_applies(
            cm, rho_collapse_choice())
        self.do_scale = blocks._rho_scale_applies(cm)
        #: the correlated-ORF joint b-draw in place of b_mh / b_refresh
        self.do_joint = cm.orf_name != "crn"
        self.joint_mixed = (current_settings().joint_mixed
                            if joint_mixed is None else bool(joint_mixed))
        #: the correlated-ORF b-draw that runs: "joint" (the structured
        #: draw), "pulsar" or "freq" (``PTGIBBS_HD_KERNEL``, past
        #: ``blocks.HD_DENSE_MAX`` coefficients); None without one
        choice = hd_kernel_choice()
        self.hd_kernel = None
        if self.do_joint:
            self.hd_kernel = (choice if cm.P * cm.Bmax > blocks.HD_DENSE_MAX
                              else "joint")
        #: the sampled ORF weights' MH block
        self.do_orf_mh = cm.orf_B is not None and len(cm.idx.orf) > 0
        self.gen = torch.Generator(device=cm.device)
        self.timer = BlockTimer(cm.device)
        #: block milliseconds of the warmup and adaptation (``timer.ms``
        #: then holds the steady sweeps alone)
        self.warmup_ms = {}
        self.aclength_white = self.aclength_ecorr = None
        self.chol_white = self.mode_white = self.asqrt_white = None
        self.chol_ecorr = self.mode_ecorr = self.asqrt_ecorr = None
        #: host copies of the white and ECORR adaptation state, for
        #: checkpoints
        self._adapt_host = {}
        #: the powerlaw block's adaptation (host float64): covariance
        #: (C, d, d) and the seed DE history (C, H, d); on the device the
        #: covariance's SVD U, S and the live DE buffer (one tensor,
        #: refilled in place), and which period's rows it holds
        self.cov_red = self.red_hist = None
        self._red_U_t = self._red_S_t = self._hist_t = None
        self._de_key = None
        #: the host record the DE window reads (set by :meth:`run`)
        self._chain = None
        #: DE periods whose buffer came from chain rows, in order
        self.de_chain_periods = []
        #: host seconds of the powerlaw block's adaptation scan
        self.red_adapt_seconds = 0.0
        # flat (pulsar, col) gather of padded (P, Bmax) b into the
        # reference's concatenated per-pulsar layout
        pi, ci = [], []
        for ii, w in enumerate(cm.widths):
            pi += [ii] * w
            ci += list(range(w))
        self._b_pi, self._b_ci = np.asarray(pi), np.asarray(ci)
        self.nb_total = len(pi)
        # a shard records its own pulsars' columns, in the same order
        mine = (self._b_pi >= cm.p0) & (self._b_pi < cm.p0 + cm.pn)
        self.nb_local = int(mine.sum())
        self._b_pi_t = torch.as_tensor(self._b_pi[mine] - cm.p0,
                                       device=cm.device)
        self._b_ci_t = torch.as_tensor(self._b_ci[mine], device=cm.device)
        #: the padded b carry (C, P, Bmax) on the host at the last
        #: writeback (the checkpoint's ``b_pad``)
        self.b = torch.zeros((self.C, cm.P, cm.Bmax), dtype=cm.cdtype)
        #: x carry (C, nx) float64 at the last writeback
        self.x_cur = None
        #: first iteration not yet run at the last writeback (a resumed
        #: run starts there)
        self.it_cur = 0
        #: per-(chain, pulsar) accepted steady Metropolised b-draws (a
        #: device counter the b_mh graph adds to) and their sweep count
        self.b_mh_accepts = torch.zeros((self.Cl, cm.pn),
                                        dtype=torch.float64,
                                        device=cm.device)
        self.b_mh_sweeps = 0
        #: the same for the steady refresh b-draws since this driver was
        #: made (a diagnostic: not checkpointed); under kernel ECORR the
        #: sweeps count the exact draws, which accept every time
        self.b_refresh_accepts = torch.zeros_like(self.b_mh_accepts)
        self.b_refresh_sweeps = 0
        #: the same for the steady powerlaw block's accepted MH steps per
        #: chain (``red_steps`` per sweep; not checkpointed)
        self.red_mh_accepts = torch.zeros(self.Cl, dtype=torch.float64,
                                          device=cm.device)
        self.red_mh_sweeps = 0
        #: the same for the steady ORF-weight MH block
        self.orf_mh_accepts = torch.zeros_like(self.red_mh_accepts)
        self.orf_mh_sweeps = 0
        #: chains whose correlated-ORF b-draw was not finite and kept
        #: their b (or, under the pulsar-wise and frequency-block draws,
        #: some of it), summed over draws on the device: [two-float
        #: b_joint, float64 draws] (not checkpointed); their host copy at
        #: the end of the warmup and adaptation, and the float64 ones by
        #: stage: the initial draw, the warmup, the adaptation
        self.b_joint_breakdowns = torch.zeros(2, dtype=torch.int64,
                                              device=cm.device)
        self.warmup_breakdowns = [0, 0]
        self.kept_by_stage = {}
        self._acc_cur = np.zeros((self.C, cm.P))
        self._b_mh_sweeps_cur = 0
        #: (chain, pulsar) Laplace factors of the warmup and adaptation
        #: that came out non-finite (their proposals are all rejected)
        self.laplace_nonfinite = torch.zeros((), dtype=torch.int64,
                                             device=cm.device)
        self.steady_sweeps = 0
        #: wall seconds of the steady phase (host clock, from the first
        #: steady chunk's queueing to the last chunk's writeback; what the
        #: caller does between the yields is inside it)
        self.steady_seconds = 0.0
        #: the steady carry (:class:`_Carry` or :class:`.graphs.
        #: SteadyGraphs`) after the last steady chunk
        self.carry = None
        self._copy_stream = None
        #: the device sketch (:mod:`..obs.sketch`): its spec, state, the
        #: state entering the last folded sweep, the spec's device index;
        #: the cumulative (n, mean, m2) host snapshot of each writeback
        self.obs = self._obs_state = self._obs_prev = None
        self._obs_index = None
        self._obs_snaps = []
        #: the sketch has folded nothing yet (its shift is set at the
        #: first steady carry)
        self._obs_fresh = True
        if obs:
            from ..obs import sketch

            self.obs = sketch.make_sketch_spec(
                cm, **(obs if isinstance(obs, dict) else {}))
            self._obs_state = sketch.init_state(self.obs, self.C, cm.device)
            self._obs_prev = torch.zeros((self.C, cm.nx), dtype=cm.cdtype,
                                         device=cm.device)
            self._obs_index = sketch.spec_index(self.obs, cm.device)
        #: the ensemble stage's spec, its state on the device (static
        #: buffers the stage updates in place) and the host copy of that
        #: state at the last writeback (the checkpoint's ``ens_*``)
        self.ens = self.ens_state = self._ens_host = None
        ens_on, n_temps = ensemble_choice(ensemble, pt_ladder)
        if ens_on:
            if not ens_mod.ensemble_applies(cm):
                raise ValueError(
                    "ensemble=True requires a CRN free-spectrum model "
                    "with a shared rho block and diagonal N (no kernel "
                    "ECORR); build with common_psd='spectrum'")
            spec = ens_mod.EnsembleSpec(n_temps=n_temps)
            ens_mod.validate_ensemble(spec, self.C)
            self.ens = spec
            self.ens_state = ens_mod.init_ens_state(spec, cm.cdtype,
                                                    cm.device)
            self._ens_host = {k: v.cpu().numpy()
                              for k, v in self.ens_state.items()}
        elif n_temps > 1:
            raise ValueError(
                "pt_ladder > 1 requires ensemble=True (tempered chains "
                "only exist inside the ensemble stage)")
        if self.shard is not None:
            self._refuse_unsharded()

    def _refuse_unsharded(self):
        """Under a mesh the driver shards the CRN free-spectrum sweep of
        the array model (white and basis-ECORR MH, the free-spectrum red
        and common rho draws, the scale moves and the b-draws); what it
        does not shard yet raises ``NotImplementedError``."""
        cm = self.cm
        what = [name for name, on in (
            ("a correlated ORF (its joint b-draw and Schur stage)",
             self.do_joint),
            ("the ensemble stage", self.ens is not None),
            ("the device sketch (obs)", self.obs is not None),
            ("the powerlaw hyper MH block", self.do_red_mh),
            ("the t-process alpha draw", self.do_tprocess),
            ("kernel ECORR", cm.has_ke),
            ("the collapsed rho draw", self.rho_collapse),
            ("a common process that is not a free spectrum",
             cm.K and cm.gw_kind != "free_spectrum"),
        ) if on]
        if what:
            raise NotImplementedError(
                f"{what[0]} does not run under a mesh yet (ROADMAP "
                "A.14b); run it without mesh=")

    # ---- streams and blocks ------------------------------------------------

    def _reseed(self, t):
        self.gen.manual_seed(stream_seed(self.seed, t))

    def betas(self):
        """(C,) per-chain inverse temperatures from the ladder's device
        state, or None without tempering."""
        if self.ens is None or self.ens.n_temps == 1:
            return None
        return ens_mod.chain_betas(self.ens, self.ens_state, self.C)

    def stage_blocks(self, t):
        """The ensemble stage's blocks after steady sweep ``t``."""
        if self.ens is None:
            return []
        out = ((["asis"] if self.ens.asis else [])
               + (["stretch"] if self.ens.stretch else []))
        if self.ens.n_temps > 1:
            out.append("pt_swap_odd" if t % 2 else "pt_swap_even")
        return out

    def sweep_order(self, exact, t):
        """Every block of steady sweep ``t`` in order: the sketch's fold
        of the pre-sweep state, the sweep's blocks, the stage's."""
        return ((["sketch"] if self.obs is not None else [])
                + self.sweep_blocks(exact) + self.stage_blocks(t))

    def chunk_extras(self):
        """Device tensors a chunk's records copy at its end: the ensemble
        state (``ens_<key>``) and the sketch's ``n``, ``mean``, ``m2``
        (``sk_<key>``)."""
        out = {}
        if self.ens is not None:
            out.update({"ens_" + k: v for k, v in self.ens_state.items()})
        if self.obs is not None:
            out.update({"sk_" + k: self._obs_state[k]
                        for k in ("n", "mean", "m2")})
        return out

    def reset_stage(self):
        """The ensemble state and the sketch as a fresh run starts them,
        in place (graphs hold the buffers)."""
        if self.ens is not None:
            init = ens_mod.init_ens_state(self.ens, self.cm.cdtype,
                                          self.cm.device)
            for k, v in init.items():
                self.ens_state[k].copy_(v)
            self._ens_host = {k: v.cpu().numpy() for k, v in init.items()}
        if self.obs is not None:
            for v in self._obs_state.values():
                v.zero_()
            self._obs_snaps = []
            self._obs_fresh = True

    def _hyper_blocks(self):
        red = ((["red"] if self.do_red_conditional else [])
               + (["tprocess"] if self.do_tprocess else [])
               + (["red_mh"] if self.do_red_mh else []))
        rho = ["rho"] if self.do_rho else []
        # the collapsed rho draw goes first: red | rho must follow it
        return ((rho + red if self.rho_collapse else red + rho)
                + (["scale"] if self.do_scale else [])
                + (["orf_mh"] if self.do_orf_mh else []))

    def sweep_blocks(self, exact):
        """Names of a steady sweep's blocks in the JAX order."""
        white = ["white"] if self.do_white and self.aclength_white else []
        ecorr = ["ecorr"] if self.do_ecorr and self.aclength_ecorr else []
        return white + ecorr + self._hyper_blocks() + [self._b_block(exact)]

    def _b_block(self, exact):
        if self.cm.has_ke and not self.do_joint:
            return "b_exact"
        if self.do_joint:
            return "b_joint_exact" if exact else "b_joint"
        return "b_refresh" if exact else "b_mh"

    def block(self, name, x, b, u):
        """One steady block on ``(x, b, u)``; returns the new triple.
        ``b_mh`` (``b_refresh``) adds its accept mask to
        :attr:`b_mh_accepts` (:attr:`b_refresh_accepts`) in place,
        ``orf_mh`` its accepted steps to :attr:`orf_mh_accepts`, and
        ``b_joint`` / ``b_joint_exact`` the chains that kept their b to
        :attr:`b_joint_breakdowns`; the stage's blocks (``asis``,
        ``stretch``, ``pt_swap_even`` / ``pt_swap_odd``) update
        :attr:`ens_state` in place, ``sketch`` folds ``x`` into the
        sketch (x, b, u unchanged).  Under tempering the white, ECORR,
        scale and b blocks run at :meth:`betas`."""
        cm, gen = self.cm, self.gen
        beta = self.betas() if name in TEMPERED_BLOCKS else None
        if name == "white":
            r = cm.y - u
            x, _ = blocks.parallel_cov_mh_scan(
                cm, x, gen, blocks.tempered_ll(
                    blocks.white_block_ll(cm, x, r, r * r), beta),
                cm.white_par_ix, cm.white_nper, self.chol_white,
                self.aclength_white, record=False, mode=self.mode_white,
                asqrt=self.asqrt_white)
        elif name == "ecorr":
            x, _ = blocks.parallel_cov_mh_scan(
                cm, x, gen, blocks.tempered_ll(
                    blocks.ecorr_block_ll(cm, x, b, cm.y - u), beta),
                cm.ecorr_par_ix, cm.ecorr_nper, self.chol_ecorr,
                self.aclength_ecorr, record=False, mode=self.mode_ecorr,
                asqrt=self.asqrt_ecorr)
        elif name == "red":
            x = blocks.red_conditional_update(cm, x, b, gen)
        elif name == "tprocess":
            x = blocks.tprocess_alpha_update(cm, x, b, gen)
        elif name == "red_mh":
            x = blocks.red_mh_block(cm, x, b, gen, self._red_U_t,
                                    self._red_S_t, self.red_steps,
                                    hist=self._hist_t,
                                    accepts=self.red_mh_accepts)
        elif name == "rho":
            x = blocks.rho_update(cm, x, b, gen, collapse=self.rho_collapse)
        elif name == "scale":
            x, b, u = blocks.rho_scale_moves(cm, x, b, u, gen, beta)
        elif name == "orf_mh":
            x, _ = blocks.mh_scan(cm, x, gen, blocks.lnlike_orf_fn(cm, b),
                                  cm.orf_ix, self.red_steps,
                                  accepts=self.orf_mh_accepts)
        elif name == "b_mh":
            b, u, acc = blocks.draw_b_mh(cm, x, b, u, gen, beta)
            self.b_mh_accepts += acc.to(torch.float64)
        elif name == "b_refresh":
            b, u, acc = blocks.draw_b_refresh(cm, x, b, u, gen, beta)
            self.b_refresh_accepts += acc.to(torch.float64)
        elif name == "b_exact":
            b = blocks.draw_b_fn(cm, x, gen, b)
            u = blocks.b_matvec(cm, b)
        elif name in ("b_joint", "b_joint_exact"):
            b = self._draw_corr(x, b, exact=name == "b_joint_exact")
            u = blocks.b_matvec(cm, b)
        elif name == "asis":
            x, b, u = ens_mod.asis_rho_redraw(cm, x, b, u, gen, beta)
        elif name == "stretch":
            es = self.ens_state
            x, nacc = ens_mod.stretch_rho_move(cm, self.ens, x, b, gen)
            es["stretch_acc"].add_(nacc)
            es["stretch_try"].add_(float(self.C // self.ens.n_temps))
        elif name in ("pt_swap_even", "pt_swap_odd"):
            x, b, u, es = ens_mod.pt_swap(cm, self.ens, x, b, u,
                                          self.ens_state, gen,
                                          int(name == "pt_swap_odd"))
            for k, v in es.items():
                self.ens_state[k].copy_(v)
        elif name == "sketch":
            from ..obs.sketch import fold_

            fold_(self.obs, self._obs_state, self._obs_prev, x,
                  self._obs_index)
        else:
            raise ValueError(f"unknown block {name!r}")
        if name in ("white", "ecorr", "red", "tprocess"):
            # the block wrote its own pulsars' slots of x
            x = sharding.sync_x(self.shard, x)
        return x, b, u

    def _draw_corr(self, x, b, exact):
        """The correlated-ORF b-draw of :attr:`hd_kernel` from ``b``
        (zeros when None), float64 when ``exact``; the chains that kept
        (some of) their b are added to :attr:`b_joint_breakdowns`."""
        cm = self.cm
        if self.hd_kernel == "joint":
            # the stage-1 factor cache is made here: the blocks between
            # the red blocks and this one move rho (and the ORF weights)
            # alone, which it does not read
            b, ok = blocks.draw_b_joint_structured(
                cm, x, self.gen, b, exact=exact, mixed=self.joint_mixed)
        else:
            if b is None:
                b = torch.zeros(x.shape[:-1] + (cm.P, cm.Bmax),
                                dtype=cm.cdtype, device=cm.device)
            draw = (blocks.draw_b_hd_sequential if self.hd_kernel == "pulsar"
                    else blocks.draw_b_hd_freqblock)
            b, ok = draw(cm, x, self.gen, b, exact=exact)
        self.b_joint_breakdowns[int(exact)] += (~ok).sum()
        return b

    def _exact_b(self, x, b=None):
        """The exact b | everything of the initial draw and the
        adaptation: under a correlated ORF the float64 draw of
        :attr:`hd_kernel` (:meth:`_draw_corr`), else ``draw_b_fn``."""
        if self.do_joint:
            return self._draw_corr(x, b, exact=True)
        return blocks.draw_b_fn(self.cm, x, self.gen, b)

    def _check_orf_start(self, x):
        """Raise ``ValueError`` when a chain's sampled ORF weights give a
        non-positive-definite G (the MH block cannot leave such a
        start)."""
        cm = self.cm
        th = x.cpu().numpy()[:, cm.orf_par_ix.cpu().numpy()]
        G = (np.eye(cm.P)[None]
             + np.einsum("cj,jpq->cpq", th, cm.orf_B.cpu().numpy()))
        wmin = np.linalg.eigvalsh(G).min(axis=(-2, -1))
        if (wmin <= 1e-10).any():
            raise ValueError(
                "initial ORF weights give a non-positive-definite "
                f"correlation matrix (min eigenvalue {wmin.min():.2e}); "
                "start the *_orfw_* parameters at 0 (G = identity) — "
                "x0[idx.orf] = 0")

    def _set_adapt(self, **state):
        """Set adaptation arrays (``chol_white``, ``mode_white``,
        ``asqrt_white`` and their ECORR twins) on the device, in the
        model's storage type, and keep host copies: a checkpoint taken
        while a chunk runs must not wait for the device."""
        cm = self.cm
        for key, val in state.items():
            t = torch.as_tensor(np.asarray(val), dtype=cm.dtype)
            self._adapt_host[key] = t.numpy()
            # (C, P, ...): a shard keeps its chains and pulsars
            t = t[self.c0:self.c0 + self.Cl, cm.p0:cm.p0 + cm.pn]
            setattr(self, key, t.contiguous().to(cm.device))

    def _count_nonfinite(self, chol):
        self.laplace_nonfinite += (~torch.isfinite(chol)).any(-1).any(
            -1).sum()

    def _ecorr_curvature(self, x, b, r):
        """The ECORR block's per-pulsar target for its Laplace factor:
        the basis coefficients' conditional, or under kernel ECORR the
        Woodbury conditional on the residual ``r`` at ``x``."""
        cm = self.cm
        if cm.has_ke:
            return blocks.ecorr_ll_ke(cm, x, r)
        return lambda q: blocks.lnlike_ecorr_per(cm, q, b)

    def _warmup_sweep(self, x, b, u):
        """Pre-adaptation sweep: Laplace random-walk white and ECORR
        sub-chains at the current state, the hyper blocks, the
        Metropolised refresh (under a correlated ORF the float64 joint
        draw: warmup states break the two-float factor; under kernel
        ECORR the exact draw)."""
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
                x = sharding.sync_x(self.shard, x)
        if self.do_ecorr:
            with tm("ecorr"):
                r = cm.y - u
                _, chol, _ = blocks.laplace_newton_chol(
                    cm, x, self._ecorr_curvature(x, b, r),
                    cm.ecorr_par_ix, cm.ecorr_nper, newton_iters=0)
                self._count_nonfinite(chol)
                x, _ = blocks.parallel_cov_mh_scan(
                    cm, x, self.gen, blocks.ecorr_block_ll(cm, x, b, r),
                    cm.ecorr_par_ix, cm.ecorr_nper, chol,
                    self.warmup_white_steps, record=False)
                x = sharding.sync_x(self.shard, x)
        for name in self._hyper_blocks():
            with tm(name):
                if name == "red_mh":
                    # single-site on the b-conditional (no proposal
                    # adaptation yet)
                    _, dyn = cm.phi_hyper_split(x)
                    x, _ = blocks.mh_scan(
                        cm, x, self.gen,
                        lambda q: blocks.lnlike_hyper_fn(cm, q, b, dyn),
                        cm.idx.red, self.red_steps)
                elif name == "orf_mh":
                    # the steady acceptance counts the steady sweeps
                    x, _ = blocks.mh_scan(
                        cm, x, self.gen, blocks.lnlike_orf_fn(cm, b),
                        cm.orf_ix, self.red_steps)
                else:
                    x, b, u = self.block(name, x, b, u)
        name = self._b_block(True)
        with tm(name):
            if self.do_joint or cm.has_ke:
                x, b, u = self.block(name, x, b, u)
            else:
                b, u, _ = blocks.draw_b_refresh(cm, x, b, u, self.gen)
        return x, b, u

    def _sweep(self, x, b, u, exact, t):
        """One eager steady sweep ``t`` (:meth:`sweep_order`); ``exact``
        selects the refresh b-draw."""
        for name in self.sweep_order(exact, t):
            with self.timer(ens_mod.TIMER_NAME.get(name, name)):
                x, b, u = self.block(name, x, b, u)
        return x, b, u

    def _adapt_block(self, x, which, curv, target, par_ix, nper):
        """One MH block's adaptation: Laplace proposals at its conditional
        mode (``curv``: per-pulsar log-likelihood), a record scan of the
        block's ``target``, the moment-matched proposal, a second record
        whose ACT (capped) sets the steady sub-chain length.  Sets
        ``chol_<which>``, ``mode_<which>``, ``asqrt_<which>`` and
        ``aclength_<which>``; returns ``x``."""
        cm = self.cm
        f32 = cm.dtype
        x, chol, asq = blocks.laplace_newton_chol(cm, x, curv, par_ix, nper)
        x = sharding.sync_x(self.shard, x)
        self._count_nonfinite(chol)
        mode = x[..., torch.clamp(par_ix, max=cm.nx - 1)]

        def record(x, chol, mode, asq):
            x, rec = blocks.parallel_cov_mh_scan(
                cm, x, self.gen, target(x), par_ix, nper, chol.to(f32),
                self.white_adapt_iters, mode=mode.to(f32),
                asqrt=asq.to(f32))
            # the proposals and the sub-chain length come from the whole
            # record (chains, steps, pulsars, slots)
            return (sharding.sync_x(self.shard, x),
                    self._assemble(rec.cpu().numpy(), 0, 2))

        nper_h = self._assemble(nper.cpu().numpy(), None, 0)
        x, rec2 = record(x, chol, mode, asq)
        m2, c2, a2 = _moment_proposal(rec2, nper_h)
        self._set_adapt(**{f"mode_{which}": m2, f"chol_{which}": c2,
                           f"asqrt_{which}": a2})
        x, rec3 = record(x, *(getattr(self, f"{k}_{which}")
                              for k in ("chol", "mode", "asqrt")))
        setattr(self, f"aclength_{which}", min(
            _act_from_rec(rec3, nper_h, cm.P_real), self.white_steps_max))
        return x

    def _set_red(self, cov, U, S, hist):
        """Take the powerlaw block's adaptation (host arrays): keep the
        host copies and put U, S and the seed DE history on the device
        (the history into the live buffer, made once)."""
        cm = self.cm
        self.cov_red = cov
        self.red_hist = np.asarray(hist, dtype=np.float64)
        self._red_U_t = torch.as_tensor(U, dtype=cm.cdtype, device=cm.device)
        self._red_S_t = torch.as_tensor(S, dtype=cm.cdtype, device=cm.device)
        h = torch.as_tensor(self.red_hist, dtype=cm.cdtype)
        if self._hist_t is None or self._hist_t.shape != h.shape:
            self._hist_t = torch.empty(h.shape, dtype=cm.cdtype,
                                       device=cm.device)
        self._hist_t.copy_(h)
        self._de_key = -1

    def _de_hist_for(self, chain, m):
        """(C, H, d) DE history of period ``m``: chain rows ``[m DE_Q -
        DE_DELAY - H, m DE_Q - DE_DELAY)`` of the host record, or the seed
        history before that window exists."""
        lo = m * DE_Q - DE_DELAY - DE_HIST_LEN
        hi = m * DE_Q - DE_DELAY
        if lo < 0:
            return self.red_hist
        rows = np.asarray(chain[lo:hi], dtype=np.float64)
        if rows.ndim == 2:          # squeezed single-chain layout
            rows = rows[:, None, :]
        return np.ascontiguousarray(
            rows[:, :, np.asarray(self.cm.idx.red)].transpose(1, 0, 2))

    def _de_select(self, t):
        """Before sweep ``t``: refill the DE buffer in place when ``t``
        starts a period whose rows it does not hold."""
        m = t // DE_Q
        key = -1 if m * DE_Q - DE_DELAY - DE_HIST_LEN < 0 else m
        if key == self._de_key:
            return
        if key >= 0 and self._chain is None:
            raise RuntimeError("the DE history needs the chain record: "
                               "sample through run()")
        self._hist_t.copy_(torch.as_tensor(self._de_hist_for(self._chain, m),
                                           dtype=self.cm.cdtype))
        self._de_key = key
        if key >= 0:
            self.de_chain_periods.append(m)

    def _adapt_red(self, x):
        """The powerlaw block's adaptation: ``red_adapt_iters`` single-site
        MH steps on the b-marginalized likelihood at the state's white
        noise (its Gram formed once), then :func:`red_adaptation` of the
        record on the host.  Returns ``x``."""
        cm = self.cm
        if cm.device.type == "cuda":
            torch.cuda.synchronize(cm.device)
        t0 = time.perf_counter()
        TNT, d = blocks.tnt_d_x(cm, x, cm.ndiag(x))
        x, rec = blocks.mh_scan(
            cm, x, self.gen,
            lambda q: blocks.lnlike_fullmarg_fn(cm, q, TNT, d),
            cm.idx.red, self.red_adapt_iters)
        rec = rec.transpose(0, 1).cpu().numpy()
        self.red_adapt_seconds = time.perf_counter() - t0
        self._set_red(*red_adaptation(rec))
        return x

    def _first_sweep(self, x, b):
        """Adaptation of the white block, then of the ECORR block (each
        by :meth:`_adapt_block`), at one exact b; the red conditional
        draw or the t-process alpha draw; the powerlaw block's adaptation
        (:meth:`_adapt_red`); the rho draw and a fresh exact b.  Returns
        ``(x, b)``."""
        cm = self.cm
        b = self._exact_b(x, b)
        if self.do_white:
            r2 = blocks.residual_sq(cm, b)
            r = cm.y - blocks.b_matvec(cm, b)
            x = self._adapt_block(
                x, "white", lambda q: blocks.lnlike_white_per(cm, q, r2),
                lambda x: blocks.white_block_ll(cm, x, r, r * r),
                cm.white_par_ix, cm.white_nper)
        if self.do_ecorr:
            r = cm.y - blocks.b_matvec(cm, b)
            x = self._adapt_block(
                x, "ecorr", self._ecorr_curvature(x, b, r),
                lambda x: blocks.ecorr_block_ll(cm, x, b, r),
                cm.ecorr_par_ix, cm.ecorr_nper)
        if self.do_red_conditional:
            x = sharding.sync_x(self.shard, blocks.red_conditional_update(
                cm, x, b, self.gen))
        if self.do_tprocess:
            x = blocks.tprocess_alpha_update(cm, x, b, self.gen)
        if self.do_red_mh:
            x = self._adapt_red(x)
        if self.do_rho:
            x = blocks.rho_update(cm, x, b, self.gen,
                                  collapse=self.rho_collapse)
        return x, self._exact_b(x, b)

    # ---- steady loop -------------------------------------------------------

    def begin_steady(self, x, b):
        """Make ``(x, b)`` (device tensors) the steady carry; with graphs
        on, capture the steady blocks' graphs around it (a capture
        failure raises)."""
        self._de_key = None     # the first sweep loads its period's rows
        if self.obs is not None:
            # the first steady transition is counted from the entry state,
            # and a fresh sketch's lagged sums are shifted by it
            self._obs_prev.copy_(x)
            if self._obs_fresh:
                from ..obs.sketch import set_shift_

                set_shift_(self.obs, self._obs_state, x, self._obs_index)
                self._obs_fresh = False
        if self.graphs:
            self.carry = None        # release an earlier run's graphs
            self.carry = SteadyGraphs(self, x, b)
        else:
            self.carry = _Carry(self, x, b)

    def steady_chunk(self, it0, n, rec=None, it_base=None):
        """Queue steady sweeps ``it0 .. it0 + n - 1`` on :attr:`carry`,
        ``u = T b`` recomputed first.  With ``rec`` (:class:`_Records`),
        the pre-sweep state of every iteration ``t`` with ``(t -
        it_base) % record_every == 0`` goes to its next row."""
        c = self.carry
        c.reset_u()
        r = 0
        for t in range(it0, it0 + n):
            if rec is not None and (t - it_base) % self.record_every == 0:
                rec.dev["xs"][r].copy_(c.x)
                rec.dev["bs"][r].copy_(c.b[:, self._b_pi_t, self._b_ci_t])
                r += 1
            if self.do_red_mh:
                self._de_select(t)
            self._reseed(t)
            exact = t % self.exact_every == 0
            c.sweep(exact, t)
            if exact:
                self.b_refresh_sweeps += 1
            else:
                self.b_mh_sweeps += 1
        self.red_mh_sweeps += n if self.do_red_mh else 0
        self.orf_mh_sweeps += n if self.do_orf_mh else 0
        self.steady_sweeps += n

    # ---- row layout (``jax_backend.py`` facade protocol) --------------------

    def _b_flat(self, b_arr):
        """(..., P, Bmax) -> (..., nb_total) reference layout."""
        return np.asarray(b_arr, dtype=np.float64)[..., self._b_pi,
                                                   self._b_ci]

    def _rows_of(self, n):
        """Recorded rows an offset-0 chunk of ``n`` sweeps ships."""
        k = self.record_every
        return (n + k - 1) // k

    def _it_base(self, niter):
        """First steady iteration: the residue anchor of the thinned
        record and the anchor of the chunk grid."""
        W = min(self.warmup_sweeps, max(0, niter - 1))
        if W > 0:
            return W + 1
        return 1 if niter <= 1 else 2

    def _row_layout(self, niter):
        """Total recorded rows of an ``niter``-sweep run: thinned warmup
        rows + the post-warmup carry row + one row per recorded steady
        iteration; equals ``niter`` at record_every=1."""
        W = min(self.warmup_sweeps, max(0, niter - 1))
        base = self._rows_of(W) + 1 if W > 0 else (1 if niter <= 1 else 2)
        it0 = self._it_base(niter)
        return base + max(0, -(-(niter - it0) // self.record_every))

    def chain_shapes(self, niter):
        """``(chain_shape, bchain_shape)`` that :meth:`run` fills; the
        chains axis appears only for nchains > 1."""
        rows = self._row_layout(niter)
        if self.C == 1:
            return (rows, self.cm.nx), (rows, self.nb_total)
        return (rows, self.C, self.cm.nx), (rows, self.C, self.nb_total)

    def _squeeze(self, arr):
        return arr[:, 0] if self.C == 1 else arr

    def _x_in(self, x):
        cm = self.cm
        x = torch.as_tensor(x, dtype=cm.cdtype, device=cm.device)
        if x.dim() == 1:
            x = x.expand(self.C, cm.nx)
        if tuple(x.shape) != (self.C, cm.nx):
            raise ValueError(f"x0 has shape {tuple(x.shape)}; expected "
                             f"({cm.nx},) or ({self.C}, {cm.nx})")
        return x[self.c0:self.c0 + self.Cl].clone()

    @staticmethod
    def _check_finite(arr, it0, what):
        """Raise :class:`..runtime.sentinels.ChainDivergence` (a
        ``FloatingPointError``) naming the first non-finite row of a host
        record."""
        bad = ~np.isfinite(arr)
        if bad.any():
            row = it0 + int(np.argwhere(bad.any(
                axis=tuple(range(1, arr.ndim))))[0][0])
            raise ChainDivergence(
                f"non-finite {what} written at row {row}: the "
                "sweep produced NaN/inf; chain files up to the previous "
                "checkpoint are valid", row=row, what="nonfinite")

    def _health_args(self):
        """``(rho_ix, lo, hi)`` of :func:`..runtime.sentinels.
        chunk_health`: the common rho coordinates and their prior bounds
        in x units (``x = 0.5 log10 rho``), all None without them; None
        with the sentinels off."""
        if self.sentinel is None:
            return None
        cm = self.cm
        if not len(cm.rho_ix_x):
            return None, None, None
        return (cm.rho_ix_x, 0.5 * float(np.log10(cm.rhomin)),
                0.5 * float(np.log10(cm.rhomax)))

    def _assemble(self, arr, c_axis, p_axis=None):
        """A host array of this rank's chains (axis ``c_axis``) and
        pulsars (axis ``p_axis``) as the logical array, on every rank of
        a mesh; ``arr`` itself on one model."""
        if self.shard is None:
            return arr
        return self.shard.mesh.assemble(arr, c_axis, p_axis)

    def _local(self, t):
        """This rank's chains and pulsars of a logical (C, P, ...)
        tensor."""
        cm = self.cm
        return t[self.c0:self.c0 + self.Cl, cm.p0:cm.p0 + cm.pn]

    def _host_health(self, xs, bs):
        """:func:`..runtime.sentinels.chunk_health` of logical host
        records (a shard's health is the whole chunk's, on every
        rank)."""
        args = self._health_args()
        if args is None:
            return None
        rho_ix = None if args[0] is None else args[0].cpu()
        return {k: v.numpy() for k, v in chunk_health(
            xs, bs, rho_ix, *args[1:]).items()}

    def _observe_health(self, health, it_end):
        """Fold a chunk's host health reductions into the monitor."""
        if self.sentinel is None:
            return
        self.sentinel.observe(health, it_end)
        self.health_last = self.sentinel.last

    # ---- run ---------------------------------------------------------------

    def _start(self, x, chain, bchain, niter):
        """Initial exact b-draw, warmup and adaptation; writes the
        warmup rows and returns ``(x, b, first steady iteration, rows
        written)``."""
        cm, k = self.cm, self.record_every
        self._reseed(INIT_STREAM)
        b = self._exact_b(x)
        u = blocks.b_matvec(cm, b)
        kept = [int(self.b_joint_breakdowns[1])]
        W = min(self.warmup_sweeps, max(0, niter - 1))
        first = 0           # rows [first, wr] get the post-warmup state
        if W > 0:
            xs, bs = [], []
            with otrace.span("warmup.chunk", sweeps=W):
                for t in range(W):
                    if t % k == 0:
                        xs.append(x.to(self.rdtype))
                        bs.append(b[:, self._b_pi_t, self._b_ci_t].to(
                            self.rdtype))
                    self._reseed(t)
                    x, b, u = self._warmup_sweep(x, b, u)
            xs_t, bs_t = torch.stack(xs), torch.stack(bs)
            health_args = self._health_args()
            if self.shard is None:
                health = (None if health_args is None else
                          {k: v.cpu().numpy() for k, v in chunk_health(
                              xs_t, bs_t, *health_args).items()})
                xs_h, bs_h = (t.float().cpu().numpy() for t in (xs_t, bs_t))
            else:
                xs_h = self._assemble(xs_t.float().cpu().numpy(), 1)
                bs_h = self._assemble(bs_t.float().cpu().numpy(), 1, 2)
                health = self._host_health(xs_h, bs_h)
            xs_h, bs_h = (self._squeeze(t.astype(np.float64))
                          for t in (xs_h, bs_h))
            self._check_finite(xs_h, 0, "warmup state")
            self._check_finite(bs_h, 0, "warmup b coefficients")
            if health is not None:
                self._observe_health(health, W)
            first = wr = self._rows_of(W)
            chain[:wr] = xs_h
            bchain[:wr] = bs_h
        else:
            # no warmup: the start state is row 0 and, when a steady
            # sweep follows, row 1 too (the JAX layout)
            W = wr = 0 if niter <= 1 else 1
        x_h = self._squeeze(self._host_x(x)[None])
        b_h = self._squeeze(self._b_flat(self._host_b(b).numpy())[None])
        self._check_finite(x_h, wr, "post-warmup state")
        self._check_finite(b_h, wr, "post-warmup b coefficients")
        chain[first:wr + 1] = x_h[0]
        bchain[first:wr + 1] = b_h[0]
        self.timer.flush()
        kept.append(int(self.b_joint_breakdowns[1]))
        self._reseed(W)
        x, b = self._first_sweep(x, b)
        self.timer.flush()
        self.warmup_ms = dict(self.timer.ms)
        self.timer.ms.clear()
        self.warmup_breakdowns = self.b_joint_breakdowns.tolist()
        kept.append(self.warmup_breakdowns[1])
        self.kept_by_stage = dict(zip(("init", "warmup", "adaptation"),
                                      np.diff([0] + kept).tolist()))
        return x, b, W + 1, wr + 1

    def _host_x(self, x):
        """The logical (C, nx) float64 host copy of the carry ``x``."""
        return self._assemble(x.cpu().numpy().astype(np.float64), 0)

    def _host_b(self, b):
        """The logical (C, P, Bmax) host tensor of the carry ``b``."""
        if self.shard is None:
            return b.cpu()
        return torch.as_tensor(self._assemble(b.cpu().numpy(), 0, 1))

    def _writeback(self, rec, chain, bchain):
        row, m, it_end, bmh_end, mark = rec.meta
        with otrace.span("chunk.d2h", row=row, rows=m):
            xs, bs, x_end, b_end, acc, health, extra = rec.read()
        if self.shard is not None:
            with otrace.span("chunk.assemble", row=row, rows=m):
                xs = self._assemble(xs, 1)
                bs = self._assemble(bs, 1, 2)
                x_end = self._assemble(x_end, 0)
                b_end = self._assemble(b_end, 0, 1)
                acc = self._assemble(acc, 0, 1)
                health = self._host_health(xs, bs)
        with otrace.span("chunk.writeback", row=row, rows=m):
            xs, bs = self._squeeze(xs), self._squeeze(bs)
            self._check_finite(xs, row, "chain state")
            self._check_finite(bs, row, "b coefficients")
            self._check_finite(b_end[None], row + m, "b carry")
            # before the state advances: a stuck-chain raise leaves the
            # checkpointable state at the previous writeback
            self._observe_health(health, it_end)
            chain[row:row + m] = xs
            bchain[row:row + m] = bs
            self.x_cur = np.asarray(x_end, np.float64)
            self.b = torch.as_tensor(b_end)
            self.it_cur = it_end
            self._acc_cur, self._b_mh_sweeps_cur = acc, bmh_end
            if self.ens is not None:
                self._ens_host = {k[4:]: v for k, v in extra.items()
                                  if k.startswith("ens_")}
            if self.obs is not None:
                # the split-R-hat trail: cumulative moments at this chunk
                self._obs_snaps.append((float(extra["sk_n"]),
                                        extra["sk_mean"].copy(),
                                        extra["sk_m2"].copy()))
            self.timer.flush(mark)
        return row + m

    def run(self, x, chain, bchain, start, niter):
        """Sample rows ``start ..`` of an ``niter``-sweep run from ``x``
        ((nx,) or (C, nx)) into ``chain``/``bchain`` (shapes of
        :meth:`chain_shapes`), yielding the rows written so far after
        each chunk.  Rows hold pre-sweep states: with ``record_every=1``,
        rows ``0..W-1`` the warmup states, row ``W`` the post-warmup
        state, row ``t > W`` the state entering steady iteration ``t``.
        ``start > 0`` resumes after :meth:`load_adapt_state`, ``x`` then
        being the checkpoint's carry."""
        cm = self.cm
        niter = int(niter)
        if niter < 1:
            raise ValueError("niter must be >= 1")
        x = self._x_in(x)
        if cm.orf_B is not None:
            self._check_orf_start(x)
        self._chain = chain
        if self.sentinel is not None:
            # a retry must not inherit the failed attempt's streaks
            self.sentinel.reset_run()
        if start == 0:
            self.b_mh_accepts.zero_()
            self.b_mh_sweeps = 0
            self.reset_stage()
            x, b, ii, rowc = self._start(x, chain, bchain, niter)
            self.x_cur = self._host_x(x)
            self.b = self._host_b(b)
            self.it_cur = ii
            self._acc_cur = self._assemble(self.b_mh_accepts.cpu().numpy(),
                                           0, 1)
            self._b_mh_sweeps_cur = self.b_mh_sweeps
            yield rowc
        else:
            rowc, ii = start, self.it_cur
            b = self._local(self.b).contiguous().to(cm.device)
        if ii >= niter:
            return
        if rowc != self._row_layout(ii):
            raise RuntimeError(
                f"resume at row {rowc} does not match the checkpoint's "
                f"iteration {ii} ({self._row_layout(ii)} rows); the chain "
                "files and adapt.npz come from different saves")
        it_base = self._it_base(niter)
        k, cs = self.record_every, self.chunk_size
        self.begin_steady(x, b)
        if cm.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(cm.device)
        recs = [_Records(self, cs // k), _Records(self, cs // k)]
        # a shard's health is taken from the assembled chunk (writeback)
        health_args = self._health_args() if self.shard is None else None
        pending = None
        # the wall of landing a chunk (the host's wait for it), smoothed:
        # the drain's estimate of what writing back the chunk in flight
        # costs, and the watchdog's observation
        wait_ema = None
        t0 = time.perf_counter()
        j = 0
        while ii < niter:
            if preemption.drain_requested():
                # queue nothing more; the chunk in flight is decided below
                break
            with otrace.span("chunk.host_prep", it0=ii):
                n = min(cs - (ii - it_base) % cs, niter - ii)
                off = (it_base - ii) % k
                m = max(0, -(-(n - off) // k))
                rec = recs[j % 2]
                rec.begin()
            with otrace.span("chunk.dispatch", it0=ii, n=n):
                self.steady_chunk(ii, n, rec, it_base)
            rec.meta = (rowc, m, ii + n, self.b_mh_sweeps,
                        self.timer.recorded)
            with otrace.span("chunk.carry_sync", it0=ii):
                rec.end(self.carry, self.b_mh_accepts, self._copy_stream,
                        health_args)
            tw = time.monotonic()
            self._guarded(lambda it0=ii: faults.fire("dispatch.chunk",
                                                     row=it0),
                          f"chunk@{ii}", pending)
            if pending is not None:
                dt = time.monotonic() - tw
                wait_ema = dt if wait_ema is None else (
                    0.3 * dt + 0.7 * wait_ema)
                telemetry.gauge("chunk_wait_ms", dt * 1e3)
                telemetry.gauge("chunk_wait_ema_ms", wait_ema * 1e3)
                if self.watchdog is not None:
                    self.watchdog.observe(dt, n=cs)
                yield self._writeback(pending, chain, bchain)
            pending = rec
            ii += n
            rowc += m
            j += 1
        if pending is not None:
            if preemption.should_abandon(wait_ema or 0.0):
                # landing it would blow the grace window: drop it (its
                # sweeps replay bitwise on resume)
                telemetry.incr("drain_abandoned_chunks")
                otrace.instant("drain.abandon_chunk", row=pending.meta[0])
            else:
                self._guarded(None, f"writeback@{pending.meta[0]}", pending)
                yield self._writeback(pending, chain, bchain)
        self.steady_seconds += time.perf_counter() - t0

    def _guarded(self, seam, what, pending):
        """Run ``seam`` (host code) and wait for ``pending``'s records to
        reach the host, under the watchdog when there is one.  Nothing
        here queues work on the card, so an abandoned worker that wakes
        late cannot touch the retry's state."""
        wd = self.watchdog
        if wd is None:
            if seam is not None:
                seam()
            return
        wd.call(seam or (lambda: None), what=what, n=self.chunk_size,
                done=None if pending is None else pending.ready)

    # ---- diagnostics ------------------------------------------------------

    def obs_summary(self):
        """Finalize the device sketch (:mod:`..obs.summary`): one copy of
        its state to the host, then NumPy: per-chain/channel mean and
        variance, Sokal ACT and ESS in sweep units (the sketch folds every
        steady sweep, before record thinning), cross-covariance, per-block
        move rates, ``act_rho_med``, ``window_saturated``, and the moment
        split-R-hat over the writebacks' snapshots (``split_rhat_moment``,
        ``rhat_max``); with the ensemble stage, its
        :meth:`ensemble_summary` under ``"ensemble"``.  Raises without
        ``obs``."""
        if self.obs is None:
            raise RuntimeError(
                "driver built without obs=; pass obs=True (or a dict of "
                "sketch options) to the driver to enable the on-device "
                "diagnostics")
        from ..obs.summary import finalize, moment_split_rhat

        state_h = {k: v.cpu().numpy() for k, v in self._obs_state.items()}
        out = finalize(self.obs, state_h)
        rhat = moment_split_rhat(self._obs_snaps, state_h)
        out["split_rhat_moment"] = rhat
        out["rhat_max"] = float(np.max(rhat)) if rhat is not None else None
        if self.ens is not None:
            out["ensemble"] = self.ensemble_summary()
        return out

    def ensemble_summary(self):
        """The stage's counters at the last writeback, rolled up
        (:func:`.ensemble.ensemble_summary`: swap rate per rung, stretch
        acceptance per temperature, the ladder); None without the
        stage."""
        if self.ens is None:
            return None
        return ens_mod.ensemble_summary(self.ens, self._ens_host)

    # ---- checkpointable state ----------------------------------------------

    def _load_ens(self, state):
        """The ensemble state of a checkpoint, into the device buffers;
        raises ``RuntimeError`` when the checkpoint's stage or ladder is
        not this sampler's."""
        got_t = state.pop("ens_pt_ladder", None)
        if self.ens is None:
            if got_t is not None:
                raise RuntimeError(
                    "resume checkpoint was written with the ensemble stage "
                    "on (pt_ladder={}) but this sampler has ensemble=False; "
                    "they must match".format(int(got_t)))
            return
        if got_t is None:
            raise RuntimeError(
                "resume checkpoint was written with the ensemble "
                "stage off but this sampler has ensemble=True; they "
                "must match (the stage changes the sampled process)")
        if int(got_t) != self.ens.n_temps:
            raise RuntimeError(
                f"resume checkpoint was written with pt_ladder="
                f"{int(got_t)} but this sampler has pt_ladder="
                f"{self.ens.n_temps}; they must match")
        host = {}
        for k, v in self.ens_state.items():
            ck = "ens_" + k
            if ck not in state:
                raise RuntimeError(
                    f"resume checkpoint lacks ensemble state {ck!r}; "
                    "it was written by an incompatible version")
            host[k] = np.asarray(state[ck], np.float64).reshape(v.shape)
            v.copy_(torch.as_tensor(host[k]))
        self._ens_host = host

    def stream_options(self):
        """The sweep options that change the random stream, as the
        checkpoint records them."""
        return {"exact_every": self.exact_every,
                "white_steps_max": self.white_steps_max,
                "warmup_white_steps": self.warmup_white_steps,
                **({"rho_collapse": 1} if self.rho_collapse else {})}

    def adapt_state(self):
        """The state a resume needs, at the last writeback: the seed
        (streams are pure in it and the iteration), the carry, the
        iteration counter, the white and ECORR adaptation and the
        powerlaw block's covariance and seed DE history."""
        out = {"seed": np.uint64(self.seed & _MASK64),
               "nchains": np.int64(self.C),
               "b_pad": self.b.numpy().astype(np.float64),
               "it_cur": np.int64(self.it_cur),
               "record_every": np.int64(self.record_every),
               **{k: np.int64(v) for k, v in self.stream_options().items()},
               "x_cur": np.asarray(
                   self.x_cur if self.x_cur is not None
                   else np.zeros((self.C, self.cm.nx))),
               "b_mh_accepts": np.asarray(self._acc_cur),
               "b_mh_sweeps": np.int64(self._b_mh_sweeps_cur),
               "rng_device": np.str_(self.gen.device.type),
               **self._adapt_host}
        if self.hd_kernel is not None:
            out["hd_kernel"] = np.str_(self.hd_kernel)
        for key in ("aclength_white", "aclength_ecorr", "cov_red",
                    "red_hist"):
            if getattr(self, key) is not None:
                out[key] = np.asarray(getattr(self, key))
        if self.ens is not None:
            # the ladder and counters are part of the sampled process
            # when tempering is on: resume restores them exactly
            out["ens_pt_ladder"] = np.int64(self.ens.n_temps)
            for k, v in self._ens_host.items():
                out["ens_" + k] = np.asarray(v)
        return out

    def load_adapt_state(self, state):
        """Take the state of :meth:`adapt_state` back: a resumed
        :meth:`run` continues from its carry at iteration ``it_cur``.

        Whatever the driver keeps of an earlier run goes: the steady carry
        and the graphs captured against it, the timer's pending blocks and
        the DE buffer's period (a run's record buffers are its own), so a
        retry on this driver replays what a fresh driver resumed from the
        same checkpoint does."""
        state = dict(state)
        cm = self.cm
        self.carry = None
        self.timer.discard()
        self._de_key = None
        missing = [k for k in ("seed", "b_pad", "it_cur", "x_cur")
                   if k not in state]
        if missing:
            raise RuntimeError(
                f"resume checkpoint lacks {', '.join(missing)} — it was "
                "written by an incompatible version; delete the chain "
                "directory to start fresh")
        got_c = int(state.pop("nchains", 1))
        if got_c != self.C:
            raise RuntimeError(
                f"resume checkpoint was written with nchains={got_c} but "
                f"this sampler has nchains={self.C}; they must match")
        got_dev = state.pop("rng_device", None)
        if got_dev is not None and str(got_dev) != self.gen.device.type:
            raise ValueError(
                f"resume checkpoint's streams were drawn on {got_dev} but "
                f"this sampler draws them on {self.gen.device.type}; the "
                "two devices' generators give different streams (RNG_RULE),"
                " so the resumed chain would not continue the saved one — "
                f"resume on {got_dev} or start fresh")
        got_k = int(state.pop("record_every", 1))
        if got_k != self.record_every:
            raise RuntimeError(
                f"resume checkpoint was written with record_every={got_k} "
                f"but this sampler has record_every={self.record_every}; "
                "they must match")
        if self.hd_kernel is not None:
            got_kern = str(state.pop("hd_kernel", "joint"))
            if got_kern != self.hd_kernel:
                raise RuntimeError(
                    f"resume checkpoint was drawn with the correlated-ORF "
                    f"b-draw {got_kern!r} (PTGIBBS_HD_KERNEL) but this "
                    f"sampler runs {self.hd_kernel!r}; the resumed chain "
                    "would not continue the saved one, so they must match")
        got_rc = bool(int(state.pop("rho_collapse", 0)))
        if got_rc != self.rho_collapse:
            raise RuntimeError(
                f"resume checkpoint was drawn with the collapsed rho draw "
                f"{'on' if got_rc else 'off'} (PTGIBBS_RHO_COLLAPSE) but "
                f"this sampler has it {'on' if self.rho_collapse else 'off'}"
                "; the resumed chain would not continue the saved one, so "
                "they must match")
        for key, val in self.stream_options().items():
            got = int(state.pop(key, val))
            if got != val:
                raise RuntimeError(
                    f"resume checkpoint was written with {key}={got} but "
                    f"this sampler has {key}={val}; the resumed chain would "
                    "not continue the saved one, so they must match")
        self.seed = int(state["seed"])
        b_pad = np.asarray(state["b_pad"], dtype=np.float64)
        want = (self.C, cm.P, cm.Bmax)
        if b_pad.shape != want:
            raise RuntimeError(
                f"resume checkpoint's b coefficients have shape "
                f"{b_pad.shape} but this sampler is built for {want}; "
                "resume with the model's original padding")
        self.b = torch.as_tensor(b_pad, dtype=cm.cdtype)
        self.it_cur = int(state["it_cur"])
        self.x_cur = np.asarray(state["x_cur"], dtype=np.float64)
        if "b_mh_accepts" in state:
            self.b_mh_accepts = self._local(torch.as_tensor(
                np.asarray(state["b_mh_accepts"]), dtype=torch.float64)
            ).contiguous().to(cm.device)
            self.b_mh_sweeps = int(state.get("b_mh_sweeps", 0))
            self._acc_cur = np.asarray(state["b_mh_accepts"])
            self._b_mh_sweeps_cur = self.b_mh_sweeps
        for key in ("aclength_white", "aclength_ecorr"):
            if key in state:
                setattr(self, key, int(state[key]))
        self._set_adapt(**{k: state[k] for k in (
            "chol_white", "mode_white", "asqrt_white", "chol_ecorr",
            "mode_ecorr", "asqrt_ecorr") if k in state})
        self._load_ens(state)
        if self.do_red_mh:
            if "cov_red" not in state or "red_hist" not in state:
                raise RuntimeError(
                    "resume checkpoint lacks the red-block adaptation "
                    "(cov_red) or DE history (red_hist) — it was written by "
                    "an incompatible version; delete the chain directory to "
                    "start fresh")
            cov = np.asarray(state["cov_red"], dtype=np.float64)
            U, S, _ = np.linalg.svd(cov)
            self._set_red(cov, U, S, state["red_hist"])
        if self.do_white and (self.aclength_white is None
                              or self.chol_white is None
                              or self.mode_white is None):
            raise RuntimeError(
                "resume checkpoint lacks white-noise adaptation state "
                "(chol/mode_white) — it was written by an incompatible "
                "version; delete the chain directory to start fresh")
        if self.do_ecorr and (self.aclength_ecorr is None
                              or self.chol_ecorr is None
                              or self.mode_ecorr is None):
            raise RuntimeError(
                "resume checkpoint lacks ECORR adaptation state "
                "(chol/mode_ecorr); delete the chain directory to start "
                "fresh")
