"""Model construction of the port (the CRN free-spectrum models)."""

from .build import (build_crn_spectrum, crn_spectrum_arrays, model_arrays,
                    model_general)

__all__ = ["build_crn_spectrum", "crn_spectrum_arrays", "model_arrays",
           "model_general"]
