"""PyTorch/CUDA port of the blocked Gibbs free-spectrum PTA sampler.

The models of the JAX package's ``model_general``
(``pulsar_timing_gibbsspec_tpu``): a free-spectrum or powerlaw-family
common process (uncorrelated, or a free spectrum under a fixed
correlated ORF), free-spectrum or powerlaw intrinsic red noise,
chromatic DM and scattering GPs, ``dm_annual``, BayesEphem, and sampled
or fixed white noise with basis ECORR, for one pulsar or an array,
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
