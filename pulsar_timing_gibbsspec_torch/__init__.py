"""PyTorch/CUDA port of the blocked Gibbs free-spectrum PTA sampler.

The CRN free-spectrum model of the JAX package
(``pulsar_timing_gibbsspec_tpu``), built from pulsar arrays and sampled
on an NVIDIA H100 with the chains as a batch axis; the two Pallas kernels
of the JAX package are hand-written CUDA here (``ops/kernels``).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .models.build import build_crn_spectrum
from .sampler.compiled import from_arrays
from .sampler.gibbs import PTABlockGibbs

__all__ = ["build_crn_spectrum", "PTABlockGibbs", "from_arrays"]
