"""The port's kernels: hand-written CUDA for Hopper with plain twins.

Port of ``pulsar_timing_gibbsspec_tpu/ops/kernels/__init__.py``'s
dispatch.  The route follows the tensor, never a setting:

- a CUDA tensor launches the CUDA kernel (``csrc/``, built at first use
  by :mod:`.build`) of its shape: the narrow form up to ``CHOL_MAX_N`` /
  ``GRAM_MAX_B1``, the wide form (``*_wide``: one thread-block cluster
  per system, or the output tiled over many CTAs) beyond, up to
  ``CHOL_WIDE_MAX_N`` / ``GRAM_WIDE_MAX_B1``; a build or launch
  failure, or a larger shape, raises;
- a CPU tensor runs the plain PyTorch version (:mod:`.reference`);
- ``chol_solve_sample(..., factor="tf")`` (the two-float refresh factor)
  runs the plain version on either device, as the JAX package never put
  it in a Pallas kernel.

Two counts show that a run's main path went through the kernels:

- on the host, each wrapper carries ``launches``, raised by one where it
  enqueues its kernel and nowhere else, and ``form_launches``, the same
  count split by the kernel's instantiation.  A call while a CUDA graph
  is captured counts the one launch it records into the graph;
- on the card, every kernel adds one to a device counter of its form each
  time it runs (:func:`device_launches`), eagerly or replayed from a CUDA
  graph, which the host never sees.

:func:`reset_launches` sets both to 0.
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
    if not 1 <= n <= CHOL_WIDE_MAX_N:
        raise ValueError(f"chol_solve_sample takes n <= {CHOL_WIDE_MAX_N}, "
                         f"got {n}")
    for t, nm in ((d, "d"), (z, "z")):
        _need(t, nm, dt, 2)
        if tuple(t.shape) != (batch, n):
            raise ValueError(f"{nm} must be {(batch, n)}, got "
                             f"{tuple(t.shape)}")
        if t.device != Sig.device:
            raise ValueError(f"{nm} is on {t.device}, Sig on {Sig.device}")
    wide = n > CHOL_MAX_N
    form = CHOL_FORMS[dt] + ("_wide" if wide else "")
    count = _counter(Sig.device, ("chol_solve_sample", form))
    L = torch.empty_like(Sig)
    Li = torch.empty_like(Sig)
    dj, mean, bp = (torch.empty_like(d) for _ in range(3))
    f64, ptrs = int(dt == torch.float64), [_ptr(t) for t in (
        Sig, d, z, L, Li, dj, mean, bp)]
    if wide:
        w = torch.empty_like(d)
        code = library().ptg_chol_solve_sample_wide(
            f64, *ptrs, _ptr(w), batch, n, float(ridge), count, _stream(Sig))
    else:
        code = library().ptg_chol_solve_sample(
            f64, *ptrs, batch, n, float(ridge), count, _stream(Sig))
    check(code, "chol_solve_sample")
    return (L, Li, dj, mean, bp), form


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
    out, form = _chol_solve_sample_cuda(Sig.contiguous(), d.contiguous(),
                                        z.to(Sig.dtype).contiguous(), ridge)
    chol_solve_sample.launches += 1
    chol_solve_sample.form_launches[form] += 1
    return out


#: instantiation name of chol_solve_sample by element type (the wide form
#: adds ``_wide``).  "f32" is the steady b-draw's proposal factor; "f64"
#: is the b-marginalized likelihood's factor
#: (``blocks.lnlike_fullmarg_fn``), which the powerlaw hyper block's
#: adaptation runs (the exact b-draws factor in plain float64 linear
#: algebra, as the JAX package does)
CHOL_FORMS = {torch.float32: "f32", torch.float64: "f64"}
#: instantiation name of gram_accumulate by kernel form number (the wide
#: form adds ``_wide``): float32 operands (forms 0-2) or, under float64
#: storage, float64 operands (form 3, whatever ``out_dtype``/``widen``)
GRAM_FORMS = ("f32", "f32_dot_f64_reduce", "widen_f64", "f64")
#: largest matrix order of chol_solve_sample and augmented width of
#: gram_accumulate the narrow kernels take, the largest the wide forms
#: take, and the row slices per pulsar of the Gram's extent scan
#: (``csrc/kernels.h``)
CHOL_MAX_N, GRAM_MAX_B1, GRAM_EXTENT_SLICES = 96, 64, 8
CHOL_WIDE_MAX_N = GRAM_WIDE_MAX_B1 = 1024
_CHOL_ALL = [f + w for w in ("", "_wide") for f in CHOL_FORMS.values()]
_GRAM_ALL = [f + w for w in ("", "_wide") for f in GRAM_FORMS]
chol_solve_sample.launches = 0
chol_solve_sample.form_launches = dict.fromkeys(_CHOL_ALL, 0)


def _gram_form(in_dtype, out_dtype, widen):
    """The kernel form (index into ``GRAM_FORMS``) of operands of
    ``in_dtype`` and an output of ``out_dtype``: float64 operands take the
    float64 form and a float64 output; float32 operands take the widening
    form for ``widen`` with a float64 output, the all-float32 form for a
    float32 output (``widen`` with a float32 output is the float32-compute
    exact Gram: float32 products, float32 reduce), else the float64-reduce
    form."""
    f32, f64 = torch.float32, torch.float64
    if out_dtype not in (f32, f64):
        raise TypeError(f"out_dtype must be float32 or float64, got "
                        f"{out_dtype}")
    if in_dtype == f64:
        if out_dtype != f64:
            raise TypeError("float64 operands give a float64 Gram, not "
                            f"{out_dtype}")
        return 3
    if in_dtype != f32:
        raise TypeError(f"Ta must be float32 or float64, got {in_dtype}")
    if out_dtype == f32:
        return 0
    return 2 if widen else 1


def _gram_accumulate_cuda(Ta, N, out_dtype, widen):
    from .build import check, library

    form = _gram_form(Ta.dtype, out_dtype, widen)
    _need(Ta, "Ta", Ta.dtype, 4)
    _need(N, "N", Ta.dtype, 2)
    Pt, nseg, m, B1 = Ta.shape
    batch, Nmax = N.shape
    if batch % Pt or Nmax > nseg * m:
        raise ValueError(f"N {tuple(N.shape)} does not pair with Ta "
                         f"{tuple(Ta.shape)}")
    if not 1 <= B1 <= GRAM_WIDE_MAX_B1:
        raise ValueError(f"gram_accumulate takes B1 <= {GRAM_WIDE_MAX_B1}, "
                         f"got {B1}")
    if N.device != Ta.device:
        raise ValueError(f"N is on {N.device}, Ta on {Ta.device}")
    wide = B1 > GRAM_MAX_B1
    name = GRAM_FORMS[form] + ("_wide" if wide else "")
    count = _counter(Ta.device, ("gram_accumulate", name))
    G = torch.empty((batch, B1, B1), dtype=out_dtype, device=Ta.device)
    if wide:    # every row is multiplied: no extent scan
        fn, extent = library().ptg_gram_accumulate_wide, None
    else:
        fn = library().ptg_gram_accumulate
        extent = torch.empty(Pt * GRAM_EXTENT_SLICES, dtype=torch.int32,
                             device=Ta.device)
    code = fn(_ptr(Ta), _ptr(N), _ptr(G),
              0 if extent is None else _ptr(extent), batch, Pt, nseg, m, B1,
              Nmax, form, count, _stream(Ta))
    check(code, "gram_accumulate")
    return G, name


def gram_accumulate(Ta, N, *, out_dtype=None, widen=False):
    """Segment-sequential Gram ``sum_s TNa[:, s]^T Ta[b % P, s]`` of the
    per-pulsar ``Ta = [T | y]`` (``(P, nseg, m, B1)``) and ``TNa = Ta /
    N`` for ``N`` ``(batch, Nmax)``, row ``b`` pairing with pulsar ``b %
    P`` -> ``(batch, B1, B1)``.  The kernel forms ``TNa`` on chip; only
    the plain version materializes it (``reference.gram_operand``).

    ``widen=True`` accumulates every product in ``out_dtype`` (float64,
    the exact ``tnt_d``; float32 under float32 compute); otherwise each
    segment is a float32 product cast to ``out_dtype`` before the
    sequential segment reduce (float32: the steady ``tnt_d_seg32``;
    float64: the refresh ``tnt_d_seg``).  Float64 operands (float64
    storage) take float64 products and sums in every call, into a
    float64 output; a float32 output of them raises."""
    if out_dtype is None:
        out_dtype = Ta.dtype
    if Ta.device.type == "cpu":
        _gram_form(Ta.dtype, out_dtype, widen)
        return reference.gram_accumulate_ref(Ta, N, out_dtype=out_dtype,
                                             widen=widen)
    out, form = _gram_accumulate_cuda(Ta.contiguous(), N.contiguous(),
                                      out_dtype, widen)
    gram_accumulate.launches += 1
    gram_accumulate.form_launches[form] += 1
    return out


gram_accumulate.launches = 0
gram_accumulate.form_launches = dict.fromkeys(_GRAM_ALL, 0)


_WRAPPERS = {fn.__name__: fn for fn in (chol_solve_sample, gram_accumulate)}
#: slot of each (kernel, form) in a device's launch counters
_SLOTS = {(k, f): i for i, (k, f) in enumerate(
    [("chol_solve_sample", f) for f in _CHOL_ALL]
    + [("gram_accumulate", f) for f in _GRAM_ALL])}
#: int64 launch counters per CUDA device, one slot per (kernel, form)
_DEVICE_COUNTS = {}


def _counter(device, key):
    """Device address of the launch counter of ``key`` on ``device``
    (allocated, zeroed, at the first launch there; never inside a CUDA
    graph capture, whose pool would own it)."""
    c = _DEVICE_COUNTS.get(device)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "a kernel's first launch on a device must precede any CUDA "
                "graph capture (its launch counters are made then)")
        c = _DEVICE_COUNTS[device] = torch.zeros(len(_SLOTS),
                                                 dtype=torch.int64,
                                                 device=device)
    return c.data_ptr() + c.element_size() * _SLOTS[key]


def reset_launches():
    """Set every kernel's launch counts to 0, on the host and the card."""
    for fn in _WRAPPERS.values():
        fn.launches = 0
        fn.form_launches = dict.fromkeys(fn.form_launches, 0)
    for c in _DEVICE_COUNTS.values():
        c.zero_()


def launch_counts():
    """``{(kernel, form): launches}`` the wrappers enqueued (host)."""
    return {(k, f): n for k, fn in _WRAPPERS.items()
            for f, n in fn.form_launches.items()}


def device_launches():
    """``{(kernel, form): runs}`` of every kernel on every card, read from
    the device counters after the cards finish their queued work: graph
    replays included."""
    out = dict.fromkeys(_SLOTS, 0)
    for dev, c in _DEVICE_COUNTS.items():
        torch.cuda.synchronize(dev)
        for key, n in zip(_SLOTS, c.tolist()):
            out[key] += n
    return out
