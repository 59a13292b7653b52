"""Fair-share scheduler: requests -> rows of one multiplexed sweep.

The port's first slice of ``pulsar_timing_gibbsspec_tpu/serve/
service.py``: one slice (one resident group at a time), a FIFO queue and
the :class:`~.engine.ProgramCache`.  Each :meth:`SamplerService.step`
runs one multiplexed chunk with admission and eviction strictly between
chunks:

- **routing** snaps each dataset to the smallest covering bucket of the
  table (:mod:`.buckets`) or fails the job with the typed
  :class:`~.buckets.BucketOverflow`; the dataset is padded to the
  bucket (``models.build.model_arrays(pad_pulsars=, pad_toas=,
  pad_basis=)``) and checked against the group's signature;
- **admission** fills free slots from the queue head; all residents
  share one (bucket, signature) group, and a job of another group waits
  until the slots empty;
- **fair share**: when the queue holds work, a resident that has held
  its slot for ``quantum`` chunks is checkpointed and requeued;
- **empty slots** carry an inert filler row (the group's canonical model
  with a fixed filler stream): rows are independent, so fillers cost
  compute but never touch a tenant's values, and the program's shapes
  never change with occupancy.

On the card each (bucket, signature, slots, chunk) program captures its
sweep once as a CUDA graph; a membership change copies the tenants' data
into the graph's static tensors and never captures again
(:meth:`~.engine.ProgramCache.captures`).

Failure handling, as the JAX service's: a chunk's per-row health vector
(``runtime.sentinels.chunk_health``) quarantines only the breaching
row's job (revert to its verified checkpoint, requeue under the
``quarantine_max`` budget, or park it terminally with the marker in its
manifest); a preemption drain checkpoints every resident to a verified
set and raises :class:`~..runtime.preemption.Preempted`;
:meth:`SamplerService.step_supervised` retries the device, crash and
stall classes after reverting every resident to its checkpoint.

Guards, as the JAX service's: with ``breaker=`` each tenant gets a
failure-rate :class:`~..runtime.supervisor.CircuitBreaker` (an open
tenant is refused at :meth:`~SamplerService.submit` with the typed
:class:`~..runtime.supervisor.CircuitOpen`, and its quarantined job
waits out the cooldown for the half-open probe); with ``admission=`` an
:class:`~..runtime.supervisor.AdmissionController` refuses submissions
past ``max_queue`` and defers cold buckets during a compile storm; with
``prewarm=N`` a queued cold bucket that cannot be placed this step is
built (``compile_bucket`` plus ``ProgramCache.adopt``, no graph
capture) while the residents keep sampling: at most one build a step,
``N`` outstanding, none during a storm, and only after a cold stall.
The JAX prewarm marks its compile planned with
``analysis.guards.planned_compile()``, a retrace guard of the JAX
package's ``analysis/`` with no counterpart here.

Trace spans, the JAX service's names and ``args`` keys:
``serve.prepare`` (routing, padding and the signature check),
``serve.prewarm``, ``serve.restack`` (loading the residents into the
program's static tensors), ``serve.compile_dispatch`` (the first chunk
of a group in this service: on the card the one that captures its
graph), ``serve.dispatch`` (seeding and queueing the replays),
``serve.d2h`` (the copy back, which waits for the card),
``serve.writeback`` (the rows into the job buffers, the live
diagnostics and the checkpoints), ``serve.drain`` and the
``serve.quarantine`` instant.  ``perf=True`` folds them into
``dispatch_ms{stage=,stat=,job="svc"}`` gauges
(:class:`~..obs.perf.StageAggregator`).

The chaos seams are the JAX service's: ``faults.fire("serve.chunk",
row=<global chunk>)`` before every dispatch,
``faults.tenant_evict_request`` and ``faults.poison_tenant_rows``.

Not in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): ``mesh``, ``placement``,
:meth:`SamplerService.append_job`, :meth:`SamplerService.evacuate` and
the slice rebalancing.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..config import resolve_device
from ..obs import trace as otrace
from ..runtime import faults, preemption, supervisor, telemetry
from .buckets import BucketOverflow, BucketTable, probe_shape
from ..sampler.gibbs import prior_sample
from .engine import (INIT_ITERATION, X0_STREAM, ProgramCache,
                     compile_bucket, frozen_params, group_key, init_b,
                     sweep_seed, tenant_seed)
from .jobs import Job

#: tenant index of the inert filler stream (far above any real tenant)
FILLER_TENANT = 0x7FFFFFFF

#: the options of the JAX service this slice does not take, by the
#: ROADMAP item that brings them
_LATER = {
    "mesh": "A.15 (multi-slice placement)",
    "placement": "A.15 (multi-slice placement)",
}


def _later(what, item):
    return NotImplementedError(
        f"{what} is not in the port's serving slice yet (ROADMAP {item})")


class SamplerService:
    """Resident multi-tenant sampler over one multiplexed program.

    ``slots`` is the tenant-axis width; ``chunk`` the sweeps per
    dispatch; ``save_every`` the checkpoint cadence in chunks;
    ``quantum`` the fair-share slice in chunks.  ``breaker`` and
    ``admission`` take True (the defaults) or the keyword arguments of
    :class:`~..runtime.supervisor.CircuitBreaker` /
    :class:`~..runtime.supervisor.AdmissionController`; ``prewarm`` is
    the budget of outstanding prebuilt buckets (0: off); ``clock`` feeds
    the breakers' cooldowns and the storm window (injectable, so tests
    never sleep); ``perf=True`` installs the streaming stage aggregator
    until :meth:`close`.  ``device`` is the card (``cuda``) unless the
    caller passes another.  The JAX service's ``ensemble`` and
    ``pt_ladder > 1`` raise its ``ValueError``; ``mesh`` and
    ``placement`` raise ``NotImplementedError``."""

    def __init__(self, root, table: BucketTable, *, slots=2, chunk=4,
                 save_every=1, quantum=8, service_seed=0, max_retries=2,
                 backoff_base=0.0, cache: ProgramCache | None = None,
                 mesh=None, ensemble=False, pt_ladder=1, perf=False,
                 quarantine_max=2, breaker=None, admission=None,
                 placement=None, prewarm=0, clock=time.monotonic,
                 device=None):
        if ensemble or int(pt_ladder) > 1:
            raise ValueError(
                "ensemble moves / parallel tempering are not available "
                "in the multiplexed service: tenant rows share the "
                "chain axis and interchain moves would mix unrelated "
                "analyses.  Run ensemble sampling through the "
                "single-tenant facade (PTABlockGibbs(ensemble=True))")
        for name, val in (("mesh", mesh), ("placement", placement)):
            if val is not None:
                raise _later(f"{name}=", _LATER[name])
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.table = table
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.chunk = int(chunk)
        self.save_every = max(1, int(save_every))
        self.quantum = max(1, int(quantum))
        self.service_seed = int(service_seed)
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.quarantine_max = int(quarantine_max)
        # a caller-supplied cache lets a successor service (warm restart
        # in the same process) reuse the predecessor's programs
        self.cache = ProgramCache() if cache is None else cache
        self.jobs: dict[str, Job] = {}
        self.queue: list[Job] = []
        self.residents: list = [None] * self.slots
        self.active = None          # the residents' group key
        self.dirty = True           # membership changed since the load
        self.program = None         # the active group's MuxProgram
        self.global_chunk = 0
        self._fillers: dict = {}    # group key -> (x, b) filler state
        self._diags: dict = {}      # job_id -> (RollingDiag, channels)
        self._evictions = 0
        self._compile_stalls = 0
        self._next_tenant = 0
        self._retries = 0
        self._quarantines = 0
        self._quarantine_log: list[dict] = []
        self._warmed: set = set()   # group keys dispatched once here
        #: host seconds of the dispatches (stack load, chunk, copy back)
        self.dispatch_seconds = 0.0

        # per-tenant circuit breakers and service-level admission
        # control; ``breaker`` / ``admission`` take True (defaults) or a
        # kwargs dict
        self._clock = clock
        self._breaker_cfg = ({} if breaker is True else breaker)
        self._breakers: dict[int, supervisor.CircuitBreaker] = {}
        if admission is True:
            admission = {}
        self._admission = None if admission is None else \
            supervisor.AdmissionController(clock=clock, **admission)

        # predictive pre-warming: budget of outstanding prebuilt
        # buckets (0 = off)
        self._prewarm_max = int(prewarm)
        self._prewarmed: set = set()
        self._prewarms = 0
        self._group_warmth: dict = {}   # bucket -> [hits, misses]

        # perf=True hangs the streaming stage aggregator off the span
        # seams: host-side folds of host timestamps, nothing enters the
        # sweep (sampling stays bitwise the same)
        self._stage_agg = None
        if perf:
            from ..obs.perf import StageAggregator

            self._stage_agg = StageAggregator(job="svc").install()

    # -- request intake -----------------------------------------------------

    def submit(self, dataset, niter, job_id=None, tenant_id=None,
               outdir=None, generation=0) -> Job:
        """Queue an analysis request (``dataset``: an
        :class:`~.engine.Dataset`).  ``tenant_id`` (with the service seed
        and ``generation``) is the stream identity: pass the original
        values to readmit a job in a fresh process, or leave None for a
        new stream.

        Refuses (``ValueError``) a model whose parameters the
        multiplexed sweep would never draw (:func:`~.engine.
        frozen_params`: ECORR, powerlaw or DM hypers, t-process alphas,
        sampled ORF weights), which the JAX service samples with those
        parameters frozen, and a correlated ORF
        (``NotImplementedError``).  Raises
        :class:`~..runtime.supervisor.CircuitOpen` when admission control
        refuses on queue-depth backpressure, or when the tenant's circuit
        breaker is open."""
        if self._admission is not None:
            self._admission.admit_submission(len(self.queue))
        arrays = dataset.model_arrays()
        frozen = frozen_params(arrays)
        if frozen:
            raise ValueError(
                "the multiplexed sweep draws the white, red free-spectrum "
                "and common free-spectrum blocks only; this model's "
                f"{len(frozen)} other parameter(s) ({', '.join(frozen[:4])}"
                f"{', ...' if len(frozen) > 4 else ''}) would stay frozen "
                "at their start.  Sample it with PTABlockGibbs")
        if str(arrays.get("orf_name", "crn")) != "crn":
            raise _later(f"orf={arrays['orf_name']!r} in the service",
                         "A.15 (correlated-ORF tenants)")
        if job_id is None:
            job_id = f"job{len(self.jobs):04d}"
        if job_id in self.jobs:
            raise ValueError(f"duplicate job_id {job_id!r}")
        if tenant_id is None:
            tenant_id = self._next_tenant
        br = self._breakers.get(int(tenant_id))
        if br is not None:
            br.check(f"tenant {int(tenant_id)}")
        self._next_tenant = max(self._next_tenant, int(tenant_id) + 1)
        if outdir is None:
            outdir = self.root / job_id
        job = Job(job_id=job_id, dataset=dataset, niter=int(niter),
                  tenant_id=int(tenant_id), outdir=str(outdir),
                  generation=int(generation))
        self.jobs[job_id] = job
        self.queue.append(job)
        telemetry.gauge("queue_depth", float(len(self.queue)))
        return job

    # -- stream / state derivation ------------------------------------------

    def _tenant_seed(self, tenant_id, generation=0):
        return tenant_seed(self.service_seed, tenant_id, generation)

    def _x0(self, job) -> np.ndarray:
        """Deterministic per-(service_seed, tenant, generation) start: a
        prior draw from the tenant's reserved start stream."""
        gen = torch.Generator().manual_seed(sweep_seed(
            self._tenant_seed(job.tenant_id, job.generation), X0_STREAM))
        return prior_sample(job.cm, 1, gen)[0].cpu().numpy()

    def _fresh_state(self, job):
        job.x = self._x0(job)
        job.b = init_b(job.cm, job.x, sweep_seed(
            self._tenant_seed(job.tenant_id, job.generation),
            INIT_ITERATION))

    # -- admission / eviction ----------------------------------------------

    def _route(self, job) -> bool:
        """Route only: sets ``job.bucket``; False after marking the job
        failed on overflow."""
        if job.bucket is not None:
            return True
        try:
            job.bucket = self.table.route(probe_shape(job.dataset))
        except BucketOverflow as exc:
            job.failure = f"overflow: {exc}"
            job.set_state("failed")
            return False
        return True

    def _prepare(self, job) -> bool:
        """Route + pad + signature check (idempotent; cached on the
        job).  False after marking the job failed on a routing error."""
        if job.cm is not None:
            return True
        job.set_state("warming")
        if not self._route(job):
            return False
        with otrace.span("serve.prepare", job=job.job_id,
                         tenant=int(job.tenant_id)):
            cm = compile_bucket(job.dataset, job.bucket, self.device)
            cm, warm = self.cache.adopt(job.bucket, cm)
        job.cm = cm
        g = self._group_warmth.setdefault(job.bucket, [0, 0])
        g[0 if warm else 1] += 1
        if not warm:
            self._compile_stalls += 1
            telemetry.gauge("compile_stalls", float(self._compile_stalls))
            if self._admission is not None:
                self._admission.note_compile()
        telemetry.gauge("warm_hit_rate", self.cache.warm_hit_rate())
        return True

    def _admit(self, job, slot):
        job.set_state("warming")
        cm = job.cm
        if job.chain is None:
            job.alloc(cm.nx, cm.P * cm.Bmax)
        if job.store is None:
            job.open_store()
            if not job.try_resume():
                self._fresh_state(job)
        job.chunks_resident = 0
        job.admitted_at = time.monotonic()
        self.residents[slot] = job
        job.set_state("sampling")
        self.dirty = True
        self._prewarmed.discard(job.bucket)

    def _evict(self, slot, reason):
        job = self.residents[slot]
        job.checkpoint()
        job.set_state("queued")
        self.residents[slot] = None
        self.queue.append(job)
        self._evictions += 1
        telemetry.gauge("tenant_evictions", float(self._evictions))
        telemetry.gauge("queue_depth", float(len(self.queue)))
        self.dirty = True

    def _tenant_breaker(self, tenant_id, create=False):
        """The tenant's circuit breaker (None when breakers are off)."""
        if self._breaker_cfg is None:
            return None
        br = self._breakers.get(int(tenant_id))
        if br is None and create:
            br = self._breakers[int(tenant_id)] = \
                supervisor.CircuitBreaker(clock=self._clock,
                                          **self._breaker_cfg)
        return br

    def _quarantine(self, slot, why):
        """Blast-radius isolation for one poisoned row: the job leaves
        its slot (a filler swaps in at the next load), the poisoned
        chunk never reaches its buffers, and it restarts from its own
        verified state (in memory ``(x, b, it)`` still hold the last
        clean chunk's end, which the checkpoint here persists).  Within
        the ``quarantine_max`` budget the job requeues in state
        ``quarantined``; past it the job parks terminally with the
        quarantine marker in its manifest.  The tenant's breaker records
        the failure."""
        job = self.residents[slot]
        job.quarantines += 1
        self._quarantines += 1
        telemetry.incr("sentinel_trips")
        telemetry.incr("quarantines")
        self._quarantine_log.append({
            "job_id": job.job_id, "tenant_id": int(job.tenant_id),
            "chunk": int(self.global_chunk), "why": why,
            "count": int(job.quarantines)})
        br = self._tenant_breaker(job.tenant_id, create=True)
        if br is not None:
            br.record_failure()
        self.residents[slot] = None
        self.dirty = True
        otrace.instant("serve.quarantine", job=job.job_id,
                       tenant=int(job.tenant_id), why=why,
                       count=int(job.quarantines))
        if job.quarantines > self.quarantine_max:
            job.failure = (f"quarantined: {why} — budget exhausted "
                           f"({job.quarantines - 1} replays); "
                           "resume requires force_requeue")
            job.set_state("quarantined")
            job.checkpoint()    # the manifest carries the marker
        else:
            # the verified checkpoint of the clean prefix, THEN the state
            # flip: the requeued job's manifest stays resumable
            job.checkpoint()
            job.set_state("quarantined")
            self.queue.append(job)
        telemetry.gauge("quarantined_jobs", float(sum(
            1 for j in self.jobs.values() if j.state == "quarantined")))
        telemetry.gauge("queue_depth", float(len(self.queue)))

    def _admissions(self):
        """Fill free slots from the queue head, one (bucket, signature)
        group at a time: a job of another group waits until the slots
        empty.  A quarantined job waits for its tenant's breaker (the
        half-open probe after the cooldown, claimed only when the job is
        admitted); during a compile storm, cold buckets are deferred."""
        if not any(self.residents):
            self.active = None
        for slot in range(self.slots):
            if self.residents[slot] is not None:
                continue
            take = None
            for job in self.queue:
                if job.state == "quarantined":
                    # non-consuming gate: claiming the probe on a group
                    # mismatch would strand the breaker half-open
                    br = self._tenant_breaker(job.tenant_id)
                    if br is not None and not br.would_allow():
                        continue        # wait out the cooldown
                if self._admission is not None and job.cm is None:
                    if not self._route(job):
                        continue        # failed routing; skip
                    if self._admission.defer_cold(
                            self.cache.has_bucket(job.bucket)):
                        continue        # compile storm: hold cold shapes
                if not self._prepare(job):
                    continue            # failed routing; skip
                key = group_key(job.bucket, job.cm)
                if self.active is None:
                    self.active = key
                if key == self.active:
                    take = job
                    break
            self.queue[:] = [j for j in self.queue if j.state != "failed"]
            if take is None:
                break
            if take.state == "quarantined":
                br = self._tenant_breaker(take.tenant_id)
                if br is not None and not br.allow():
                    break       # probe raced away; retry next round
            self.queue.remove(take)
            telemetry.gauge("queue_depth", float(len(self.queue)))
            self._admit(take, slot)

    # -- predictive pre-warming --------------------------------------------

    def _job_waiting(self, job) -> bool:
        """True when the routed job cannot be placed this step: the slots
        hold another group, or its group has no free slot."""
        if not any(self.residents):
            return False        # an empty service will take it
        if self.active is not None and self.active[0] == job.bucket \
                and any(r is None for r in self.residents):
            return False        # its group has a free slot
        return True

    def _prewarm(self):
        """Build the first queued cold bucket that must wait anyway,
        while the residents keep sampling.  At most one build a step, at
        most ``prewarm`` outstanding buckets, none during a compile
        storm, and only when ``compile_stalls`` / ``warm_hit_rate`` show
        that cold builds hurt."""
        if not self._prewarm_max or not self.queue:
            return
        if self._admission is not None and self._admission.storming():
            return      # storm: the deferral already shields the slots
        if len(self._prewarmed) >= self._prewarm_max:
            return
        if not (self._compile_stalls > 0
                or self.cache.warm_hit_rate() < 1.0):
            return      # no evidence that cold builds hurt
        for job in list(self.queue):
            if job.cm is not None or job.state == "quarantined":
                continue
            if not self._route(job):
                continue
            if self.cache.has_bucket(job.bucket) or \
                    job.bucket in self._prewarmed:
                continue
            if not self._job_waiting(job):
                continue
            with otrace.span("serve.prewarm", job=job.job_id,
                             bucket=str(job.bucket.as_tuple())):
                cm = compile_bucket(job.dataset, job.bucket, self.device)
                self.cache.adopt(job.bucket, cm)
            self._prewarmed.add(job.bucket)
            self._prewarms += 1
            telemetry.incr("serve_prewarms")
            telemetry.gauge("serve_prewarms", float(self._prewarms))
            if self._admission is not None:
                self._admission.note_compile()
            return      # at most one prewarm build a step

    # -- the multiplexed chunk ---------------------------------------------

    def _filler_state(self, key, canon):
        """Host (x, b) of the inert filler stream of one group (the prior
        midpoint, the reserved-iteration b draw)."""
        got = self._fillers.get(key)
        if got is None:
            pa = canon.pa.cpu().numpy().astype(np.float64)
            pb = canon.pb.cpu().numpy().astype(np.float64)
            pk = canon.pkind.cpu().numpy()
            # uniform / LinearExp: the bound midpoint; normal: its mean
            x = np.where(pk == 1, pa, 0.5 * (pa + pb))
            b = init_b(canon, x, sweep_seed(self._tenant_seed(FILLER_TENANT),
                                            INIT_ITERATION))
            got = self._fillers[key] = (x, b)
        return got

    def _load(self):
        """Membership changed: put every slot's model and state into the
        program's static tensors (no capture)."""
        live = [j for j in self.residents if j is not None]
        canon = self.cache.canonical(live[0].bucket, live[0].cm)
        self.program = self.cache.program(self.active, self.slots,
                                          self.chunk)
        fx, fb = self._filler_state(self.active, canon)
        for t, job in enumerate(self.residents):
            if job is None:
                self.program.load(t, canon, fx, fb)
            else:
                self.program.load(t, job.cm, job.x, job.b)
        self.dirty = False

    def _seeds(self):
        """``seeds[s][t]``: slot t's generator seed at sweep s of this
        chunk: its tenant's stream at absolute iteration ``it + 1 + s``
        (fillers: their fixed stream from iteration 1)."""
        rows = []
        for job in self.residents:
            if job is None:
                base, it0 = self._tenant_seed(FILLER_TENANT), 1
            else:
                base = self._tenant_seed(job.tenant_id, job.generation)
                it0 = job.it + 1
            rows.append([sweep_seed(base, it0 + s)
                         for s in range(self.chunk)])
        return [list(col) for col in zip(*rows)]

    def _dispatch(self):
        """One multiplexed chunk; the rows scattered to the job buffers,
        a row that fails its health check quarantined alone; then the
        finished jobs retire and the residents checkpoint."""
        t0 = time.perf_counter()
        if self.dirty:
            with otrace.span("serve.restack", slice=0):
                self._load()
        # on the card a group's first chunk captures its graph: a
        # capture wall, kept out of the steady stage's span
        name = ("serve.dispatch" if self.active in self._warmed
                else "serve.compile_dispatch")
        with otrace.span(name, chunk=self.global_chunk, slice=0):
            xs, bs, health = self.program.run(self._seeds())
        self._warmed.add(self.active)
        with otrace.span("serve.d2h", chunk=self.global_chunk):
            np_xs = xs.cpu().numpy().astype(np.float64)  # (chunk, T, nx)
            np_bs = bs.cpu().numpy().astype(np.float64)  # (chunk, T, P, B)
            h_fin = health["finite"].cpu().numpy()
            h_rho = health["rho_ok"].cpu().numpy()
        self.dispatch_seconds += time.perf_counter() - t0
        live = {int(j.tenant_id): (s, j.chunks_resident)
                for s, j in enumerate(self.residents) if j is not None}
        np_xs, np_bs, _ = faults.poison_tenant_rows(
            np_xs, np_bs, {t: s for t, (s, _) in live.items()},
            {t: r for t, (_, r) in live.items()})
        now = time.monotonic()
        with otrace.span("serve.writeback", chunk=self.global_chunk):
            for slot, job in enumerate(self.residents):
                if job is None:
                    continue
                rows = np_xs[:, slot]
                brows = np_bs[:, slot].reshape(self.chunk, -1)
                take = min(self.chunk, job.niter - job.it)
                breach = None
                if not h_fin[slot]:
                    breach = "non-finite row (device health)"
                elif not h_rho[slot]:
                    breach = "rho-bound breach (device health)"
                elif not (np.isfinite(rows[:take]).all()
                          and np.isfinite(brows[:take]).all()):
                    breach = "non-finite chunk rows (host)"
                if breach is not None:
                    self._quarantine(slot, breach)
                    continue
                job.chain[job.it:job.it + take] = rows[:take]
                job.bchain[job.it:job.it + take] = brows[:take]
                job.it += take
                job.x = rows[take - 1].copy()
                job.b = np_bs[take - 1, slot].copy()
                job.chunks_resident += 1
                if job.first_sample_at is None:
                    job.first_sample_at = now
                    telemetry.gauge("time_to_first_sample_ms",
                                    job.time_to_first_sample_ms())
                br = self._breakers.get(int(job.tenant_id))
                if br is not None:
                    br.record_success()
                self._observe_job(job, rows[:take], now)
            self._retire()

    def _retire(self):
        """After a chunk: a finished job checkpoints and leaves its slot;
        the others checkpoint every ``save_every`` resident chunks."""
        for slot, job in enumerate(self.residents):
            if job is None:
                continue
            if job.done:
                job.checkpoint()
                job.set_state("done")
                self.residents[slot] = None
                self.dirty = True
            elif job.chunks_resident % self.save_every == 0:
                job.checkpoint()

    def _observe_job(self, job, rows, now):
        """Feed the job's live diagnostics window and publish its gauges
        (labelled per job and tenant)."""
        got = self._diags.get(job.job_id)
        if got is None:
            from ..obs.sketch import make_sketch_spec
            from ..obs.summary import RollingDiag

            ch = np.asarray(make_sketch_spec(job.cm).channels)
            got = self._diags[job.job_id] = (RollingDiag(), ch)
        diag, ch = got
        diag.observe(rows[:, ch], now)
        lab = {"job": job.job_id, "tenant": str(int(job.tenant_id))}
        telemetry.gauge("serve_ess_per_sec", diag.ess_per_sec(), **lab)
        telemetry.gauge("serve_rhat_max", diag.rhat_max(), **lab)
        telemetry.gauge("serve_accept_rate", diag.accept_rate(), **lab)

    # -- drain / recovery ---------------------------------------------------

    def _drain(self):
        """Checkpoint every resident to a verified set and raise
        ``Preempted``: each job resumes from its own directory."""
        from ..runtime import integrity

        rows = 0
        all_ok = True
        n = sum(1 for j in self.residents if j is not None)
        with otrace.span("serve.drain", jobs=n):
            for job in self.residents:
                if job is None:
                    continue
                job.set_state("draining")
                job.checkpoint()
                if not integrity.verify(job.store.outdir)["ok"]:
                    all_ok = integrity.rollback(job.store.outdir) \
                        and all_ok
                rows += job.it
                job.set_state("queued")     # resumable, not failed
        preemption.mark_drained()
        raise preemption.Preempted(
            f"service drained {n} job(s) to per-job checkpoints",
            rows=rows, verified=all_ok)

    def _revert_residents(self):
        """Roll every resident back to its last verified checkpoint (the
        retry path: the replay from there is bit-exact)."""
        for job in self.residents:
            if job is None:
                continue
            job.it = 0
            if not job.try_resume():
                self._fresh_state(job)
        self.dirty = True

    # -- scheduler loop -----------------------------------------------------

    def step(self) -> bool:
        """One scheduling round: seam, churn, admission, pre-warm, one
        chunk, checkpoints.  Returns False when there is nothing to
        run."""
        if preemption.drain_requested() and any(self.residents):
            self._drain()
        self.global_chunk += 1
        faults.fire("serve.chunk", row=self.global_chunk)
        evict_req = faults.tenant_evict_request(
            row=self.global_chunk,
            job_rows={int(j.tenant_id): j.chunks_resident
                      for j in self.residents if j is not None})
        if evict_req:
            evicted_any = False
            for slot, job in enumerate(self.residents):
                if job is None:
                    continue
                if evict_req is True:
                    if not evicted_any:     # untargeted: any one
                        self._evict(slot, "injected")
                        evicted_any = True
                elif int(job.tenant_id) in evict_req:
                    self._evict(slot, "injected")
        # fair share: the longest-resident tenant yields to a non-empty
        # queue after its quantum
        if self.queue:
            held = [(j.chunks_resident, s)
                    for s, j in enumerate(self.residents) if j is not None]
            if held:
                most, slot = max(held)
                if most >= self.quantum:
                    self._evict(slot, "quantum")
        self._admissions()
        self._prewarm()
        if not any(self.residents):
            return False
        self._dispatch()
        telemetry.gauge("queue_depth", float(len(self.queue)))
        return True

    def step_supervised(self) -> bool:
        """One scheduling round under the recovery ladder: the device,
        crash and stall classes (``supervisor.classify_failure``) revert
        every resident to its verified checkpoint and back off
        deterministically (up to ``max_retries``); ``user`` / ``unknown``
        errors, an exhausted budget and ``Preempted`` re-raise."""
        try:
            return self.step()
        except preemption.Preempted:
            raise
        except Exception as exc:                 # noqa: BLE001
            cls = supervisor.classify_failure(exc)
            if cls in ("user", "unknown") \
                    or self._retries >= self.max_retries:
                raise
            self._retries += 1
            telemetry.incr("retries")
            time.sleep(supervisor.backoff_delay(
                self._retries, base=self.backoff_base, jitter=0.0,
                seed=self.service_seed))
            self._revert_residents()
            return True

    def run(self) -> dict:
        """Drive every submitted job to done / failed / parked.  When
        every queued job is deferred (a breaker's cooldown, a compile
        storm) the loop idles briefly instead of spinning."""
        while True:
            if not self.step_supervised():
                if not self.queue:
                    break
                time.sleep(0.005)
        return self.report()

    def captures(self) -> int:
        """The program cache's graph captures."""
        return self.cache.captures()

    def prometheus(self) -> str:
        """Prometheus text exposition of the process telemetry registry
        (counters ``_total`` and gauges, labels kept)."""
        from ..obs import metrics

        return metrics.render_telemetry()

    def report(self) -> dict:
        """Jobs, counters and gauges, with the JAX report's keys for the
        guards: ``breakers`` (per tenant), ``admission``, and the JAX
        ``placement`` block's ``prewarms`` and per-bucket ``groups``
        warmth at the top level (the port has one slice);
        ``stage_summary`` under ``perf=True``."""
        jobs = {jid: {"state": j.state, "it": int(j.it),
                      "tenant_id": int(j.tenant_id),
                      "retries": int(j.retries),
                      "quarantines": int(j.quarantines),
                      "failure": j.failure,
                      "time_to_first_sample_ms":
                          j.time_to_first_sample_ms()}
                for jid, j in self.jobs.items()}
        out = {
            "jobs": jobs,
            "chunks": int(self.global_chunk),
            "evictions": int(self._evictions),
            "compile_stalls": int(self._compile_stalls),
            "warm_hit_rate": self.cache.warm_hit_rate(),
            "captures": self.captures(),
            "service_retries": int(self._retries),
            "quarantines": int(self._quarantines),
            "quarantine_log": list(self._quarantine_log),
            "breakers": {t: b.snapshot()
                         for t, b in self._breakers.items()},
            "admission": (None if self._admission is None
                          else self._admission.snapshot()),
            "prewarms": int(self._prewarms),
            "groups": {
                str(tuple(b.as_tuple())): {
                    "hits": int(h), "misses": int(m),
                    "warm_hit_rate": (h / (h + m)) if (h + m) else 0.0}
                for b, (h, m) in self._group_warmth.items()},
            "device": str(self.device),
            "gauges": telemetry.gauges(),
        }
        if self._stage_agg is not None:
            out["stage_summary"] = self._stage_agg.summary()
        return out

    def close(self) -> None:
        """Release the resident program and detach the perf aggregator;
        the cache and the checkpoints stay for a warm successor."""
        self.program = None
        if self._stage_agg is not None:
            self._stage_agg.uninstall()
            self._stage_agg = None

    # -- later slices -------------------------------------------------------

    def append_job(self, *args, **kwargs):
        raise _later("append_job", "A.15 (append_job with data/append.py "
                     "and runtime/lineage.py)")

    def evacuate(self, *args, **kwargs):
        raise _later("evacuate", "A.15 (multi-slice placement)")

    def split_slice(self, *args, **kwargs):
        raise _later("split_slice", "A.15 (multi-slice placement)")

    def merge_slices(self, *args, **kwargs):
        raise _later("merge_slices", "A.15 (multi-slice placement)")
