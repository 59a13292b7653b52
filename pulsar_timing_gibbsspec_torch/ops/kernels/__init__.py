"""The port's kernels: hand-written CUDA for Hopper with plain twins.

Port of ``pulsar_timing_gibbsspec_tpu/ops/kernels/__init__.py``'s
dispatch.  The route follows the tensor, never a setting:

- a CUDA tensor launches the CUDA kernel (``csrc/``, built at first use
  by :mod:`.build`); a build or launch failure raises;
- a CPU tensor runs the plain PyTorch version (:mod:`.reference`);
- ``chol_solve_sample(..., factor="tf")`` (the two-float refresh factor)
  runs the plain version on either device, as the JAX package never put
  it in a Pallas kernel.

Each wrapper carries ``launches``, a plain count raised by one at every
kernel launch and nowhere else, and ``form_launches``, the same count
split by the kernel's instantiation, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import torch

from . import reference


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
    return t.data_ptr()


def _need(t, name, dtype, ndim):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _chol_solve_sample_cuda(Sig, d, z, ridge):
    from .build import check, library

    dt = Sig.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"Sig must be float32 or float64, got {dt}")
    _need(Sig, "Sig", dt, 3)
    batch, n, n2 = Sig.shape
    if n != n2:
        raise ValueError(f"Sig must be square, got {tuple(Sig.shape)}")
    for t, nm in ((d, "d"), (z, "z")):
        _need(t, nm, dt, 2)
        if tuple(t.shape) != (batch, n):
            raise ValueError(f"{nm} must be {(batch, n)}, got "
                             f"{tuple(t.shape)}")
        if t.device != Sig.device:
            raise ValueError(f"{nm} is on {t.device}, Sig on {Sig.device}")
    L = torch.empty_like(Sig)
    Li = torch.empty_like(Sig)
    dj, mean, bp = (torch.empty_like(d) for _ in range(3))
    code = library().ptg_chol_solve_sample(
        int(dt == torch.float64), _ptr(Sig), _ptr(d), _ptr(z), _ptr(L),
        _ptr(Li), _ptr(dj), _ptr(mean), _ptr(bp), batch, n, float(ridge),
        _stream(Sig))
    check(code, "chol_solve_sample")
    return L, Li, dj, mean, bp


def chol_solve_sample(Sig, d, z, *, ridge=0.0, factor="blocked"):
    """Fused Jacobi-preconditioned Cholesky -> inverse -> mean and
    sample solves over a ``(batch, n, n)`` stack: the five outputs
    ``(L, Li, dj, mean, bp)`` of ``linalg.jacobi_factor_mean_prop`` with
    ``bp = mean + dj * Li^T z``."""
    if factor not in ("blocked", "tf"):
        raise ValueError(f"factor={factor!r} must be 'blocked' or 'tf'")
    if factor == "tf" or Sig.device.type == "cpu":
        return reference.chol_solve_sample_ref(Sig, d, z, ridge=ridge,
                                               factor=factor)
    out = _chol_solve_sample_cuda(Sig.contiguous(), d.contiguous(),
                                  z.to(Sig.dtype).contiguous(), ridge)
    chol_solve_sample.launches += 1
    chol_solve_sample.form_launches[CHOL_FORMS[Sig.dtype]] += 1
    return out


#: instantiation name of chol_solve_sample by element type.  No sampler
#: path launches "f64" (the exact draws factor in plain float64 linear
#: algebra, as the JAX package does): it exists to check the kernel's
#: algorithm at float64 (``chip_smoke.py`` phase 2, the card test)
CHOL_FORMS = {torch.float32: "f32", torch.float64: "f64"}
#: instantiation name of gram_accumulate by kernel form number
GRAM_FORMS = ("f32", "f32_dot_f64_reduce", "widen_f64")
chol_solve_sample.launches = 0
chol_solve_sample.form_launches = dict.fromkeys(CHOL_FORMS.values(), 0)


def _gram_accumulate_cuda(TNa, Ta, out_dtype, widen):
    from .build import check, library

    f32 = torch.float32
    _need(TNa, "TNa", f32, 4)
    _need(Ta, "Ta", f32, 4)
    batch, nseg, m, B1 = TNa.shape
    if tuple(Ta.shape[1:]) != (nseg, m, B1) or batch % Ta.shape[0]:
        raise ValueError(f"Ta {tuple(Ta.shape)} does not pair with TNa "
                         f"{tuple(TNa.shape)}")
    if Ta.device != TNa.device:
        raise ValueError(f"Ta is on {Ta.device}, TNa on {TNa.device}")
    if widen:
        if out_dtype != torch.float64:
            raise TypeError("widen=True accumulates in float64")
        form = 2
    elif out_dtype == torch.float64:
        form = 1
    elif out_dtype == f32:
        form = 0
    else:
        raise TypeError(f"out_dtype must be float32 or float64, got "
                        f"{out_dtype}")
    G = torch.empty((batch, B1, B1), dtype=out_dtype, device=TNa.device)
    code = library().ptg_gram_accumulate(
        _ptr(TNa), _ptr(Ta), _ptr(G), batch, Ta.shape[0], nseg, m, B1,
        form, _stream(TNa))
    check(code, "gram_accumulate")
    return G, GRAM_FORMS[form]


def gram_accumulate(TNa, Ta, *, out_dtype=None, widen=False):
    """Segment-sequential Gram ``sum_s TNa[:, s]^T Ta[:, s]`` over
    ``(batch, nseg, m, B1)`` operands -> ``(batch, B1, B1)``; ``Ta`` may
    hold one row per pulsar, shared by the chains (row ``b % len(Ta)``).

    ``widen=True`` accumulates every product in ``out_dtype`` (float64,
    the exact ``tnt_d``); otherwise each segment is a float32 product
    cast to ``out_dtype`` before the sequential segment reduce (float32:
    the steady ``tnt_d_seg32``; float64: the refresh ``tnt_d_seg``)."""
    if out_dtype is None:
        out_dtype = TNa.dtype
    if TNa.device.type == "cpu":
        return reference.gram_accumulate_ref(TNa, Ta, out_dtype=out_dtype,
                                             widen=widen)
    out, form = _gram_accumulate_cuda(TNa.contiguous(), Ta.contiguous(),
                                      out_dtype, widen)
    gram_accumulate.launches += 1
    gram_accumulate.form_launches[form] += 1
    return out


gram_accumulate.launches = 0
gram_accumulate.form_launches = dict.fromkeys(GRAM_FORMS, 0)


def reset_launches():
    """Set every kernel's launch counts to 0."""
    for fn in (chol_solve_sample, gram_accumulate):
        fn.launches = 0
        fn.form_launches = dict.fromkeys(fn.form_launches, 0)
