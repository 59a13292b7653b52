"""Model construction of the port (the CRN free-spectrum PTA)."""

from .build import build_crn_spectrum, crn_spectrum_arrays

__all__ = ["build_crn_spectrum", "crn_spectrum_arrays"]
