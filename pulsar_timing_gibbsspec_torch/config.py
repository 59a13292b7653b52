"""Settings of the PyTorch port and the device rule of its entry points.

The subset of ``pulsar_timing_gibbsspec_tpu/config.py`` the CRN
free-spectrum sweep reads: float32 storage of the large arrays (basis,
residuals, per-TOA noise), float64 compute of the sampler state,
reductions and exact factorizations, the TOA-segment lengths of the
segmented Gram, the steady chunk length and the rho grid size.

Float32 products are full IEEE float32 everywhere in the port (the JAX
package's ``precision="highest"``): :func:`resolve_device` turns TF32 off
for matrix products and cuDNN before any work reaches a card.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Settings:
    """Knobs read when a model is built or a driver starts."""

    #: storage dtype of the large device arrays (basis, residuals, N)
    dtype: torch.dtype = torch.float32
    #: compute dtype of the sampler state, reductions and exact solves
    cdtype: torch.dtype = torch.float64
    #: TOA-segment length of the segmented float32 Gram (steady and
    #: refresh b-draws): in-segment float32 accumulation is bounded by
    #: ~sqrt(seg)*eps_f32 of the Jacobi scale sqrt(G_bb G_cc)
    gram_seg_len: int = 96
    #: TOA-segment length of the exact (widening float64) Gram
    gram_seg_len_exact: int = 96
    #: steady sweeps per recorded chunk (one host copy of the records)
    chunk_size: int = 100
    #: points of the log-uniform rho grid of the free-spectrum draws
    rho_grid_size: int = 1000


settings = Settings()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  A CUDA request without a card raises; there is no
    quiet move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    return dev
