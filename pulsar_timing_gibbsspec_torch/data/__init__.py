"""Host-side data of the port: the pulsar record, its enterprise
adapter and snapshot loader, the Fourier basis and the seeded synthetic
array and its noise dictionary."""

from .dataset import (Pulsar, from_enterprise, get_tspan,
                      load_enterprise_snapshot)
from .simulate import inject_residuals, synthetic_array, synthetic_noisedict

__all__ = ["Pulsar", "from_enterprise", "get_tspan", "inject_residuals",
           "load_enterprise_snapshot", "synthetic_array",
           "synthetic_noisedict"]
