"""Per-request state: lifecycle, stream identity, per-job checkpoints.

The port's copy of ``pulsar_timing_gibbsspec_tpu/serve/jobs.py``
(without the standing-model migration, which waits for the lineage
slice).  A job's randomness is fully determined by ``(service_seed,
tenant_id, generation)``: its tenant seed is
``engine.tenant_seed(service_seed, tenant_id, generation)`` and every
sweep seeds its slot's generator from that seed and the absolute
iteration, so a job resumed after eviction, crash or in a fresh process
replays bit-identically, and two jobs never share a stream.

Each job owns a checkpoint directory with the standard verified set
(``ChainStore``: chain.npy / bchain.npy / adapt.npz + manifest.json +
rotating ``.bak``), the JAX job's set file for file: ``adapt.npz``
carries the carries ``x`` and ``b``, ``tenant_id``, ``generation`` and
the iteration count; the manifest's ``serve`` section records the
identity needed to readmit the job anywhere (:meth:`Job.manifest_extra`).

States (mapped onto the supervisor failure taxonomy by the service):

- ``queued``      waiting for a slot
- ``warming``     bucket routing / padding / signature check / b-init
- ``sampling``    resident: a row of the multiplexed sweep
- ``draining``    preemption drain: checkpointing to a verified set
- ``quarantined`` row-health breach: reverted to its verified
  checkpoint and requeued, or (budget exhausted) parked terminally with
  the marker in its manifest (``integrity.load_resume`` refuses the
  directory without ``force_requeue``)
- ``done``        niter recorded rows checkpointed
- ``failed``      terminal failure (``Job.failure`` carries the class)
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

JOB_STATES = ("queued", "warming", "sampling", "draining", "quarantined",
              "done", "failed")


@dataclasses.dataclass
class Job:
    """One analysis request and its runtime state."""

    job_id: str
    dataset: object               # engine.Dataset
    niter: int
    tenant_id: int
    outdir: str
    state: str = "queued"
    failure: str | None = None
    generation: int = 0

    # routing / compiled artifacts (set at admission)
    bucket: object = None
    cm: object = None             # the model at the bucket's shape
    store: object = None          # ChainStore over outdir

    # progress
    it: int = 0                   # recorded rows so far
    chain: np.ndarray | None = None    # (niter, nx) float64
    bchain: np.ndarray | None = None   # (niter, P*Bmax) float64
    x: np.ndarray | None = None        # (nx,) current state
    b: np.ndarray | None = None        # (P, Bmax) current coefficients
    retries: int = 0
    chunks_resident: int = 0      # chunks since last admission (fair share)
    quarantines: int = 0          # row-health breaches (capped budget)

    # SLO bookkeeping
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    first_sample_at: float | None = None
    admitted_at: float | None = None

    def set_state(self, state: str):
        if state not in JOB_STATES:
            raise ValueError(f"unknown job state {state!r}")
        self.state = state

    @property
    def done(self) -> bool:
        return self.it >= self.niter

    def time_to_first_sample_ms(self) -> float | None:
        if self.first_sample_at is None:
            return None
        return 1e3 * (self.first_sample_at - self.submitted_at)

    # -- checkpointing ------------------------------------------------------

    def open_store(self):
        """Create the per-job ChainStore (writes the pars sidecars that
        ``integrity.load_resume`` rebuilds the store from)."""
        from ..sampler.chains import ChainStore

        cm = self.cm
        bnames = [f"b_p{p}_c{j}" for p in range(cm.P)
                  for j in range(cm.Bmax)]
        self.store = ChainStore(self.outdir, list(cm.param_names), bnames)
        return self.store

    def manifest_extra(self) -> dict:
        """Identity the next incarnation needs to readmit this job with
        the same stream and progress accounting."""
        return {"serve": {
            "job_id": self.job_id,
            "tenant_id": int(self.tenant_id),
            "niter": int(self.niter),
            "bucket": list(self.bucket.as_tuple()),
            "state": self.state,
            "generation": int(self.generation),
            "pulsars": [str(p) for p in self.cm.pulsars],
        }}

    def adapt_state(self) -> dict:
        # ChainStore.save stamps ``iter`` itself (from ``upto``)
        return {
            "x": np.asarray(self.x, np.float64),
            "b": np.asarray(self.b, np.float64),
            "tenant_id": np.asarray(self.tenant_id, np.int64),
            "generation": np.asarray(self.generation, np.int64),
        }

    def checkpoint(self):
        """Persist rows [0, it) + carries through the verified-save
        protocol (tmp + replace per file, manifest last, ``.bak``
        rotation)."""
        self.store.save(self.chain[:self.it], self.bchain[:self.it],
                        self.it, adapt_state=self.adapt_state(),
                        extra=self.manifest_extra())

    def try_resume(self, force_requeue=False) -> bool:
        """Load a verified checkpoint from ``outdir`` if one exists
        (``integrity.load_resume``: manifest verification, ``.bak``
        rollback, ``CheckpointError`` when unrecoverable, the refusal of
        a quarantine-marked directory unless ``force_requeue``).  A
        checkpoint of another tenant or another generation is refused
        (``RuntimeError``).  Returns True when progress was restored."""
        from ..runtime import integrity

        got = integrity.load_resume(self.outdir,
                                    force_requeue=force_requeue)
        if got is None:
            return False
        chain, bchain, upto, adapt = got
        if int(adapt["tenant_id"]) != int(self.tenant_id):
            raise RuntimeError(
                f"checkpoint in {self.outdir} belongs to tenant "
                f"{int(adapt['tenant_id'])}, not {self.tenant_id} — "
                "refusing a stream-crossing resume")
        ck_gen = int(adapt["generation"]) if "generation" in adapt else 0
        if ck_gen != int(self.generation):
            raise RuntimeError(
                f"checkpoint in {self.outdir} is generation {ck_gen}, "
                f"not {self.generation} — refusing a generation-"
                "crossing resume (streams are re-keyed per generation)")
        self.it = int(upto)
        self.chain[:self.it] = chain[:self.it]
        self.bchain[:self.it] = bchain[:self.it]
        self.x = np.asarray(adapt["x"], np.float64)
        self.b = np.asarray(adapt["b"], np.float64)
        return True

    def alloc(self, nx: int, nb: int):
        """Host record buffers (float64, like the facade's)."""
        self.chain = np.zeros((self.niter, nx), np.float64)
        self.bchain = np.zeros((self.niter, nb), np.float64)
