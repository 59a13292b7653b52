"""Plain PyTorch versions of the port's two kernels.

Port of ``pulsar_timing_gibbsspec_tpu/ops/kernels/reference.py``.  These
are what a CPU tensor runs, the oracle the CPU tests hold against the
JAX package, and what ``chip_smoke.py`` holds the CUDA kernels against
on the card.  The segment reduce of :func:`gram_accumulate_ref` is
sequential and left-to-right, the kernels' order; its operand ``TNa =
Ta / N`` is materialized here (:func:`gram_operand`), where the kernel
forms it on chip.
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


def gram_operand(Ta, N):
    """``TNa = Ta / N`` on ``Ta``'s segment grid, ``(batch, nseg, m,
    B1)``: row ``b`` of ``N`` (``(batch, Nmax)``) divides pulsar ``b %
    len(Ta)``'s rows below ``Nmax``; rows at or beyond ``Nmax`` are zero.
    The plain version's operand; the kernels form it on chip instead."""
    Pt, nseg, m, B1 = Ta.shape
    nb, Nmax = N.shape
    if nb % Pt:
        raise ValueError(f"N batch {nb} is not a multiple of Ta's {Pt}")
    if Nmax > nseg * m:
        raise ValueError(f"N has {Nmax} TOAs, the segment grid {nseg * m}")
    Tf = Ta.reshape(Pt, nseg * m, B1)[:, :Nmax]
    TNa = Tf / N.reshape(nb // Pt, Pt, Nmax)[..., None]
    TNa = torch.nn.functional.pad(TNa, (0, 0, 0, nseg * m - Nmax))
    return TNa.reshape(nb, nseg, m, B1)


def _segment_dot(TNa, Ta, s, out_dtype, widen):
    """One segment's partial Gram: float64 products of the float32
    operands (``widen``), or a float32 product cast to ``out_dtype``."""
    a, b = TNa[..., s, :, :], Ta[..., s, :, :]
    if widen:
        return torch.matmul(a.to(out_dtype).transpose(-1, -2),
                            b.to(out_dtype))
    return torch.matmul(a.transpose(-1, -2), b).to(out_dtype)


def gram_accumulate_ref(Ta, N, *, out_dtype=None, widen=False):
    """Sequential-segment Gram ``sum_s TNa[:, s]^T Ta[b % P, s]`` with
    ``TNa = gram_operand(Ta, N)``: ``Ta`` (P, nseg, m, B1), ``N``
    (batch, Nmax) -> ``(batch, B1, B1)``."""
    if out_dtype is None:
        out_dtype = Ta.dtype
    TNa = gram_operand(Ta, N)
    nb, Pt = TNa.shape[0], Ta.shape[0]
    A = TNa.reshape((nb // Pt, Pt) + TNa.shape[1:])
    acc = _segment_dot(A, Ta, 0, out_dtype, widen)
    for s in range(1, Ta.shape[1]):
        acc = acc + _segment_dot(A, Ta, s, out_dtype, widen)
    return acc.reshape((nb,) + acc.shape[2:])
