"""Host-side data of the port: the pulsar record, the Fourier basis and
the seeded synthetic array."""

from .dataset import Pulsar, get_tspan
from .simulate import inject_residuals, synthetic_array

__all__ = ["Pulsar", "get_tspan", "inject_residuals", "synthetic_array"]
