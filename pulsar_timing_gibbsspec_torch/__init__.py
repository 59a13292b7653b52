"""PyTorch/CUDA port of the blocked Gibbs free-spectrum PTA sampler.

The CRN models of the JAX package (``pulsar_timing_gibbsspec_tpu``):
a free-spectrum or powerlaw common process, free-spectrum or powerlaw
intrinsic red noise, for one pulsar (with basis ECORR) or an array,
built from pulsar records and sampled on an NVIDIA H100 with the chains
as a batch axis; the two Pallas kernels of the JAX package
are hand-written CUDA here (``ops/kernels``).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from .models.build import build_crn_spectrum, model_general
from .sampler.compiled import from_arrays
from .sampler.gibbs import PTABlockGibbs, PulsarBlockGibbs

__all__ = ["build_crn_spectrum", "model_general", "PTABlockGibbs",
           "PulsarBlockGibbs", "from_arrays"]
