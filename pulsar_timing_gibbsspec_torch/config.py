"""Settings of the PyTorch port and the device rule of its entry points.

The subset of ``pulsar_timing_gibbsspec_tpu/config.py`` the port's
sweeps read: the storage precision of the large arrays (basis,
residuals, per-TOA noise: ``PTGIBBS_PRECISION``, float32 by default),
the compute precision of the sampler state, reductions and exact
factorizations (``PTGIBBS_COMPUTE``, float64 by default), the
TOA-segment lengths of the segmented Grams (``PTGIBBS_GRAM_SEG``,
``PTGIBBS_GRAM_SEG_EXACT``), the rho grid size, the correlated-ORF joint
draw's mixed precision (``PTGIBBS_JOINT_MIXED``), the record precision
(``PTGIBBS_RECORD``), the ensemble stage's knobs (``PTGIBBS_ENSEMBLE``,
``PTGIBBS_PT_LADDER``) and the collapsed rho draw's switch
(``PTGIBBS_RHO_COLLAPSE``).

Two differences from the JAX package:

- **when the environment is read.**  The JAX ``Settings`` reads
  ``PTGIBBS_PRECISION``, ``PTGIBBS_COMPUTE`` and ``PTGIBBS_JOINT_MIXED``
  when its module is imported.  The port reads every variable when a
  model is built (:func:`current_settings`, called by ``model_arrays``
  and :func:`~.sampler.compiled.from_arrays`) or a driver starts, so one
  process can build models of both storage precisions.  The module's
  :data:`settings` holds the defaults and reads nothing;
- **a misspelt precision raises.**  The JAX package maps any
  ``PTGIBBS_PRECISION`` other than ``"f64"`` to float32 storage (and any
  ``PTGIBBS_COMPUTE`` other than ``"f64"`` to the storage dtype), so
  ``"F64"`` or ``"double"`` runs float32 without a word.  The port takes
  ``f32`` and ``f64`` only and raises :class:`SettingsError` naming the
  variable for anything else (ROADMAP C.21).

Float32 products are full IEEE float32 everywhere in the port (the JAX
package's ``precision="highest"``): :func:`resolve_device` turns TF32 off
for matrix products and cuDNN before any work reaches a card.
"""

from __future__ import annotations

import dataclasses
import os

import torch


class SettingsError(ValueError):
    """A malformed setting: a bad constructor value or a bad
    ``PTGIBBS_*`` environment override (the JAX package's type)."""


def _env_int(env: str, default: str) -> int:
    """A positive-integer environment override, validated at read time
    (the JAX package's checks and messages)."""
    raw = os.environ.get(env, default)
    try:
        val = int(str(raw).strip())
    except (TypeError, ValueError) as e:
        raise SettingsError(
            f"{env}={raw!r} is not an integer") from e
    if val <= 0:
        raise SettingsError(
            f"{env}={val} must be a positive integer")
    return val


#: the storage and compute precisions by name
PRECISIONS = {"f32": torch.float32, "f64": torch.float64}


def _env_precision(env: str, default: str) -> str:
    """``f32`` or ``f64`` from ``env``; anything else raises (the JAX
    package would read it as float32)."""
    raw = os.environ.get(env, default)
    if raw not in PRECISIONS:
        raise SettingsError(
            f"{env}={raw!r} must be one of {sorted(PRECISIONS)}")
    return raw


@dataclasses.dataclass(frozen=True)
class Settings:
    """Knobs read when a model is built or a driver starts."""

    #: storage precision of the large device arrays (basis, residuals,
    #: N): "f32" (default) or "f64"
    precision: str = "f32"
    #: compute precision of the sampler state, reductions and exact
    #: solves: "f64" (default) or "f32", which is the storage dtype: so
    #: "f32" compute matters only under float32 storage
    compute_precision: str = "f64"
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

    def __post_init__(self):
        for name, env in (("precision", "PTGIBBS_PRECISION"),
                          ("compute_precision", "PTGIBBS_COMPUTE")):
            v = getattr(self, name)
            if v not in PRECISIONS:
                raise SettingsError(
                    f"settings.{name}={v!r} must be one of "
                    f"{sorted(PRECISIONS)} (env: {env})")
        for name in ("gram_seg_len", "gram_seg_len_exact"):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, int) or v <= 0:
                raise SettingsError(
                    f"settings.{name}={v!r} must be a positive integer "
                    "(env: PTGIBBS_GRAM_SEG / PTGIBBS_GRAM_SEG_EXACT)")

    @property
    def dtype(self) -> torch.dtype:
        """Storage dtype (the JAX ``real_dtype()``)."""
        return PRECISIONS[self.precision]

    @property
    def cdtype(self) -> torch.dtype:
        """Compute dtype (the JAX ``compute_dtype()``): float64 under
        "f64" compute, else the storage dtype."""
        return (torch.float64 if self.compute_precision == "f64"
                else self.dtype)


#: the defaults (no environment read): what a model built without the
#: variables gets
settings = Settings()


def current_settings() -> Settings:
    """The settings the environment names, with the JAX defaults; read
    when a model is built or a driver starts."""
    return Settings(
        precision=_env_precision("PTGIBBS_PRECISION", "f32"),
        compute_precision=_env_precision("PTGIBBS_COMPUTE", "f64"),
        gram_seg_len=_env_int("PTGIBBS_GRAM_SEG", "96"),
        gram_seg_len_exact=_env_int("PTGIBBS_GRAM_SEG_EXACT", "96"),
        joint_mixed=os.environ.get("PTGIBBS_JOINT_MIXED", "1") != "0")


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
