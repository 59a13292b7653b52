"""Host-side data of the port: the pulsar record, its par/tim readers,
design matrix and loaders, its enterprise adapter and snapshot loader,
the Fourier basis and the seeded synthetic array and its noise
dictionary."""

from .dataset import (Pulsar, from_enterprise, get_tspan, load_directory,
                      load_enterprise_snapshot, load_pulsar)
from .design import design_matrix
from .fourier import fourier_basis
from .partim import parse_par, parse_tim
from .simulate import inject_residuals, synthetic_array, synthetic_noisedict

__all__ = ["Pulsar", "design_matrix", "fourier_basis", "from_enterprise",
           "get_tspan", "inject_residuals", "load_directory",
           "load_enterprise_snapshot", "load_pulsar", "parse_par",
           "parse_tim", "synthetic_array", "synthetic_noisedict"]
