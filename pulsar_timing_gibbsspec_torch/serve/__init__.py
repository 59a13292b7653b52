"""Resident multi-tenant sampler service (the port's first serving
slice).

The port of ``pulsar_timing_gibbsspec_tpu/serve/`` without its transport
frontend: a small table of padded shapes (:mod:`.buckets`), a program
cache that lands the datasets of one shape signature on one captured
multiplexed sweep (:mod:`.engine`), per-request state and checkpoints
(:mod:`.jobs`), and a fair-share scheduler that runs independent
analyses as rows of that sweep (:mod:`.service`).
"""

from .buckets import (BucketOverflow, BucketSpec, BucketTable, DatasetShape,
                      MigrationPlan, next_covering,
                      plan_migration, probe_shape)
from .engine import (Dataset, ProgramCache, SignatureMismatch,
                     bench_dataset, model_signature, stack_models)
from .jobs import JOB_STATES, Job
from .service import SamplerService

__all__ = [
    "BucketOverflow", "BucketSpec", "BucketTable", "DatasetShape",
    "MigrationPlan", "next_covering", "plan_migration", "probe_shape",
    "Dataset", "ProgramCache", "SignatureMismatch", "bench_dataset",
    "model_signature", "stack_models", "JOB_STATES", "Job",
    "SamplerService",
]
