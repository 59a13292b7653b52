"""Settings of the PyTorch port and the device rule of its entry points.

The subset of ``pulsar_timing_gibbsspec_tpu/config.py`` the port's
sweeps read: float32 storage of the large arrays (basis, residuals,
per-TOA noise), float64 compute of the sampler state, reductions and
exact factorizations, the TOA-segment lengths of the segmented Gram, the
rho grid size, the correlated-ORF joint draw's mixed precision, the
record precision (``PTGIBBS_RECORD``), the ensemble stage's knobs
(``PTGIBBS_ENSEMBLE``, ``PTGIBBS_PT_LADDER``) and the collapsed rho
draw's switch (``PTGIBBS_RHO_COLLAPSE``).

Float32 products are full IEEE float32 everywhere in the port (the JAX
package's ``precision="highest"``): :func:`resolve_device` turns TF32 off
for matrix products and cuDNN before any work reaches a card.
"""

from __future__ import annotations

import dataclasses
import os

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
    #: points of the log-uniform rho grid of the free-spectrum draws
    rho_grid_size: int = 1000
    #: mixed precision of the correlated-ORF joint b-draw: steady sweeps
    #: factor both stages with the two-float factor (float32 factors and
    #: one refinement step, ``ops.linalg.tf_chol_factor``); every
    #: ``EXACT_EVERY``-th sweep, the warmup and the initial draws factor
    #: in float64 whatever this says.  False: float64 everywhere
    joint_mixed: bool = True


settings = Settings()

#: the correlated-ORF b-draws ``PTGIBBS_HD_KERNEL`` chooses between: the
#: structured joint draw, the pulsar-wise sweep, the frequency-block sweep
HD_KERNELS = ("joint", "pulsar", "freq")


def hd_kernel_choice() -> str:
    """The correlated-ORF b-draw ``PTGIBBS_HD_KERNEL`` names (``joint``
    when unset), checked as the JAX package checks it; read when a
    driver is built, so one process can run all three."""
    choice = os.environ.get("PTGIBBS_HD_KERNEL", "joint")
    if choice not in HD_KERNELS:
        raise ValueError(
            f"PTGIBBS_HD_KERNEL={choice!r}: the correlated-ORF "
            "kernel must be 'joint' (production), 'pulsar' or 'freq'")
    return choice


def rho_collapse_choice() -> bool:
    """True when ``PTGIBBS_RHO_COLLAPSE=1``: the partially collapsed
    common-rho draw (the JAX package's opt-in switch, off by default);
    read when a driver is built, so one process can run both draws."""
    return os.environ.get("PTGIBBS_RHO_COLLAPSE", "") == "1"


def ensemble_choice(ensemble=None, pt_ladder=None):
    """``(ensemble, pt_ladder)`` of a driver: the arguments, or where one
    is None the environment variables ``PTGIBBS_ENSEMBLE`` (on unless
    unset or ``"0"``) and ``PTGIBBS_PT_LADDER`` (``1`` when unset), the
    JAX package's knobs with its defaults (the stage off, no tempering);
    read when a driver is built.  A ladder depth below 1 raises."""
    ens = (os.environ.get("PTGIBBS_ENSEMBLE", "0") != "0"
           if ensemble is None else bool(ensemble))
    T = int(os.environ.get("PTGIBBS_PT_LADDER", "1")
            if pt_ladder is None else pt_ladder)
    if T < 1:
        raise ValueError(f"pt_ladder={T} must be >= 1")
    return ens, T


#: the record precisions: the dtype the recorded rows (x and b) are
#: rounded to before they leave the card
RECORD_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def record_dtype(choice=None) -> torch.dtype:
    """The dtype of the recorded rows: ``choice`` (``"f32"`` or
    ``"bf16"``), or when None the environment variable
    ``PTGIBBS_RECORD`` (``"f32"`` when unset), as the JAX package's
    ``settings.record_precision`` reads it; read when a driver is built.
    Rounds the record only: the carry, ``adapt.npz`` and resume stay
    exact."""
    rp = choice or os.environ.get("PTGIBBS_RECORD", "f32")
    if rp not in RECORD_DTYPES:
        raise ValueError(f"record_precision must be 'f32' or 'bf16', "
                         f"got {rp!r}")
    return RECORD_DTYPES[rp]


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
