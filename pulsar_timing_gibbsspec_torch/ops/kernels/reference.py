"""Plain PyTorch versions of the port's two kernels.

Port of ``pulsar_timing_gibbsspec_tpu/ops/kernels/reference.py``.  These
are what a CPU tensor runs, the oracle the CPU tests hold against the
JAX package, and what ``chip_smoke.py`` holds the CUDA kernels against
on the card.  The segment reduce of :func:`gram_accumulate_ref` is
sequential and left-to-right, the kernels' order.
"""

from __future__ import annotations

import torch

from ..linalg import jacobi_factor_mean_prop, tf_chol_factor


def chol_solve_sample_ref(Sig, d, z, *, ridge=0.0, factor="blocked"):
    """Jacobi preconditioning, blocked (or two-float) factorization and
    the fused mean/sample solve.  Returns ``(L, Li, dj, mean, bp)``.

    ``factor="blocked"`` adds ``ridge`` to the preconditioned matrix;
    ``factor="tf"`` applies it to ``tf_chol_factor``'s float32 stage only,
    where the two-float congruence correction removes it."""
    if factor == "tf":
        return jacobi_factor_mean_prop(
            Sig, d, z, factor=lambda A: tf_chol_factor(A, ridge=ridge))
    if factor != "blocked":
        raise ValueError(f"factor={factor!r} must be 'blocked' or 'tf'")
    return jacobi_factor_mean_prop(Sig, d, z, ridge=ridge)


def _segment_dot(TNa, Ta, s, out_dtype, widen):
    """One segment's partial Gram: float64 products of the float32
    operands (``widen``), or a float32 product cast to ``out_dtype``."""
    a, b = TNa[..., s, :, :], Ta[..., s, :, :]
    if widen:
        return torch.matmul(a.to(out_dtype).transpose(-1, -2),
                            b.to(out_dtype))
    return torch.matmul(a.transpose(-1, -2), b).to(out_dtype)


def gram_accumulate_ref(TNa, Ta, *, out_dtype=None, widen=False):
    """Sequential-segment Gram over ``(batch, nseg, m, B1)`` operands ->
    ``(batch, B1, B1)``.  ``Ta`` may have fewer batch rows than ``TNa``
    (one per pulsar): row ``b`` of ``TNa`` pairs with row ``b % len(Ta)``
    of ``Ta``, the kernel's rule."""
    if out_dtype is None:
        out_dtype = TNa.dtype
    nb, nbt = TNa.shape[0], Ta.shape[0]
    if nb % nbt:
        raise ValueError(f"TNa batch {nb} is not a multiple of Ta's {nbt}")
    A = TNa.reshape((nb // nbt, nbt) + TNa.shape[1:])
    nseg = TNa.shape[1]
    acc = _segment_dot(A, Ta, 0, out_dtype, widen)
    for s in range(1, nseg):
        acc = acc + _segment_dot(A, Ta, s, out_dtype, widen)
    return acc.reshape((nb,) + acc.shape[2:])
