"""Program cache + tenant-multiplexed sweep engine.

The port's counterpart of ``pulsar_timing_gibbsspec_tpu/serve/engine.py``.
The JAX package lands heterogeneous datasets on one compiled program by
grafting a canonical static box; the port lands them on one *captured
CUDA graph*:

- a (bucket, model signature) group shares every static field a sweep
  reads (shapes, counts, kinds, prior bounds, Gibbs block positions:
  :func:`model_signature`, :func:`adopt_static`), so its members differ
  only in tensor data;
- :func:`stack_models` stacks T such models into one tenant stack, a
  :class:`~..sampler.compiled.CompiledPTA` whose per-pulsar tensors lead
  with a tenant axis; the port's ``*_core`` blocks take it as they take
  one model, row t of ``x`` (T, nx) / ``b`` (T, P, Bmax) being tenant t's
  chain;
- :class:`MuxProgram` keeps one such stack, the carries and the records
  in static tensors and, on the card, captures the sweep once as a CUDA
  graph; a change of membership copies the new tenants' data into the
  static tensors (:meth:`MuxProgram.load`) and replays the same graph.

One sweep (:func:`mux_sweep_core`) is the JAX ``sharded_sweep_step``
(``jax_backend.py``) over the tenant axis: the white MH sub-chain (3
steps), the red free-spectrum draw, the common rho draw and the exact b
draw (the widening Gram kernel at T P systems, then the float64 factor).

Each slot draws its noise from a generator of its own, seeded per sweep
from its tenant's stream (:func:`sweep_seed`): the noise of a row is a
pure function of (service seed, tenant, generation, absolute
iteration), whatever its slot, its co-residents or the slot count.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import settings
from ..ops import kernels
from ..runtime.sentinels import chunk_health
from ..sampler import blocks
from ..sampler.compiled import CompiledPTA, GPComponent, from_arrays
from ..sampler.driver import stream_seed

#: white MH steps per sweep of the multiplexed chunk (the JAX
#: ``sharded_sweep_step``'s ``mh_scan(..., 3)``)
WHITE_STEPS = 3
#: salt of a forked generation's stream (the JAX service's ``_GEN_SALT``)
GEN_SALT = 0x67656E
#: the reserved iteration of a fresh tenant's b draw (recorded sweeps
#: start at absolute iteration 1), and the stream index of its start
#: (the driver's ``INIT_STREAM``)
INIT_ITERATION = 0
X0_STREAM = -1


class SignatureMismatch(ValueError):
    """Two models cannot share a captured program: a static field a
    sweep reads differs."""


#: static fields a sweep reads; value equality is required before two
#: models share a program.  ``param_names`` is deliberately absent:
#: host-only labels
_GRAFT_EQ_FIELDS = (
    "P", "P_real", "Nmax", "Bmax", "nx", "K", "Kr", "widths",
    "gw_kind", "red_kind", "orf_name", "red_shares_gw",
    "rhomin", "rhomax", "red_rhomin", "red_rhomax",
)

#: optional tensor fields whose None-ness changes the stack's layout
_NONEABLE_FIELDS = ("orf_Ginv", "gp_mask", "red_f", "red_df", "orf_B",
                    "orf_par_ix", "ke_eid", "ke_par_ix")

#: Gibbs block positions in x, equal across a group
_IDX_FIELDS = ("rho", "red", "red_rho", "white", "ecorr", "orf")

#: tensor fields a tenant stack shares: positions in x, equal across a
#: group by :func:`adopt_static`
_SHARED = ("rho_ix_x",)


def model_signature(cm) -> tuple:
    """Hashable static identity of a compiled model: two models with
    equal signatures (plus equal Gibbs block indices, verified by
    :func:`adopt_static`) share one captured program."""
    return (
        tuple((f, getattr(cm, f)) for f in _GRAFT_EQ_FIELDS),
        ("dtype", str(cm.dtype)),
        ("cdtype", str(cm.cdtype)),
        ("components", tuple(c.kind for c in cm.components)),
        ("none", tuple(getattr(cm, f) is None for f in _NONEABLE_FIELDS)),
    )


def group_key(bucket, cm) -> tuple:
    """Canonical ``(bucket, signature)`` group identity: jobs with equal
    group keys multiplex through one program and share a slot stack."""
    return (bucket, model_signature(cm))


def adopt_static(cm, canon):
    """Verify that ``cm`` may share ``canon``'s program: the whole static
    surface (:func:`model_signature`) and the Gibbs block indices (the
    sweep's constants) equal.  Raises :class:`SignatureMismatch` on any
    difference, where the JAX function raises it; returns ``cm`` (the
    port grafts nothing: the program's static tensors take the data)."""
    sig, csig = model_signature(cm), model_signature(canon)
    if sig != csig:
        diff = [a for a, b in zip(sig, csig) if a != b]
        raise SignatureMismatch(
            f"cannot share a compiled program: {diff!r}")
    for f in _IDX_FIELDS:
        if not np.array_equal(getattr(cm.idx, f), getattr(canon.idx, f)):
            raise SignatureMismatch(
                f"Gibbs block index '{f}' differs between datasets "
                "with equal shape signatures")
    return cm


# ===========================================================================
# datasets
# ===========================================================================

class Dataset:
    """One analysis request's data and model: the pulsars and the
    options of :func:`~..models.build.model_general` (its defaults where
    not given).  :meth:`model_arrays` builds the arrays, unpadded or at
    a bucket's padded shape."""

    def __init__(self, psrs, **opts):
        self.psrs = list(psrs)
        self.opts = dict(opts)
        self._arrays = None

    def model_arrays(self, pad_pulsars=None, pad_toas=None,
                     pad_basis=None) -> dict:
        from ..models.build import model_arrays

        if pad_pulsars is None and pad_toas is None and pad_basis is None:
            if self._arrays is None:
                self._arrays = model_arrays(self.psrs, **self.opts)
            return self._arrays
        return model_arrays(self.psrs, pad_pulsars=pad_pulsars,
                            pad_toas=pad_toas, pad_basis=pad_basis,
                            **self.opts)


def bench_dataset(psrs, nbins=10, red_bins=10) -> Dataset:
    """``bench.py::build_pta``'s CRN model of ``psrs``: SVD timing model,
    varied white noise, a common and a per-pulsar red free spectrum."""
    return Dataset(psrs, tm_svd=True, white_vary=True,
                   common_psd="spectrum", common_components=nbins,
                   red_var=True, red_psd="spectrum",
                   red_components=red_bins)


def frozen_params(arrays) -> list:
    """The sampled parameters the multiplexed sweep would never move:
    every coordinate outside the white, red free-spectrum and common
    free-spectrum blocks (ECORR, powerlaw / DM hypers, t-process alphas,
    sampled ORF weights).  The JAX service samples such a model with
    those parameters frozen at their start; the port refuses it."""
    from ..sampler.compiled import BlockIndex

    names = list(arrays["param_names"])
    idx = BlockIndex.build(names)
    drawn = set(idx.white) | set(idx.red_rho) | set(idx.rho)
    return [nm for j, nm in enumerate(names) if j not in drawn]


def compile_bucket(dataset, bucket, device=None):
    """``dataset``'s model at the bucket's padded geometry, on
    ``device`` (exact by the padding conventions of :mod:`.buckets`)."""
    return from_arrays(dataset.model_arrays(
        pad_pulsars=int(bucket.pulsars), pad_toas=int(bucket.toas),
        pad_basis=int(bucket.basis)), device=device)


# ===========================================================================
# tenant stacks
# ===========================================================================

def _tensor_fields():
    return [f.name for f in dataclasses.fields(CompiledPTA)
            if f.init and f.name not in ("components", "idx", "arrays")]


def stack_models(cms) -> CompiledPTA:
    """Stack T models of one group into a tenant stack: every tensor
    field gains a leading tenant axis (``rho_ix_x``, positions in x,
    stays shared), static fields and labels come from the first model.
    Raises :class:`SignatureMismatch` when a member would not share the
    first one's program or a tensor's shape differs."""
    cm0 = cms[0]
    for cm in cms[1:]:
        adopt_static(cm, cm0)
    for name in _SHARED:
        for cm in cms[1:]:
            if not torch.equal(getattr(cm, name), getattr(cm0, name)):
                raise SignatureMismatch(f"shared field {name!r} differs")

    def stack(vals, name):
        shapes = {(tuple(v.shape), v.dtype) for v in vals}
        if len(shapes) > 1:
            raise SignatureMismatch(
                f"stacked field {name!r} shapes differ: {sorted(shapes)}")
        return torch.stack(vals)

    kw = {}
    for name in _tensor_fields():
        v0 = getattr(cm0, name)
        if torch.is_tensor(v0) and name not in _SHARED:
            kw[name] = stack([getattr(c, name) for c in cms], name)
        else:
            kw[name] = v0
    comps = []
    for j, c0 in enumerate(cm0.components):
        parts = [c.components[j] for c in cms]
        comps.append(GPComponent(c0.kind, *(
            stack([getattr(p, k) for p in parts], f"components.{k}")
            for k in ("cols", "rho_ix", "f", "df", "hyp_ix"))))
    kw.update(components=comps, idx=cm0.idx, arrays=None,
              tenants=len(cms))
    return CompiledPTA(**kw)


def _row_tensors(stack_cm, cm):
    """``(stacked, single)`` tensor pairs of a stack and one model."""
    for name in _tensor_fields():
        dst = getattr(stack_cm, name)
        if torch.is_tensor(dst) and name not in _SHARED:
            yield dst, getattr(cm, name)
    for cs, c in zip(stack_cm.components, cm.components):
        for k in ("cols", "rho_ix", "f", "df", "hyp_ix"):
            yield getattr(cs, k), getattr(c, k)


def load_row(stack_cm, t, cm) -> None:
    """Copy model ``cm``'s tensors into row ``t`` of the tenant stack, in
    place (a captured graph keeps reading the same tensors)."""
    for dst, src in _row_tensors(stack_cm, cm):
        dst[t].copy_(src)


# ===========================================================================
# the multiplexed sweep
# ===========================================================================

class SweepNoise(NamedTuple):
    """One sweep's noise over the tenant axis, as the JAX step draws it:
    white MH ``scale``, ``jpos``, ``eps``, ``logu`` (steps, T); red
    Gumbels (T, P, Kr, R); the rho draw's Gumbels (T, K, R) or, for one
    pulsar without red noise, its uniforms (T, K); the b normals (T, P,
    Bmax)."""

    scale: torch.Tensor
    jpos: torch.Tensor
    eps: torch.Tensor
    logu: torch.Tensor
    g_red: torch.Tensor
    rho: torch.Tensor
    z: torch.Tensor


def row_noise(cm, gen) -> tuple:
    """One row's share of :class:`SweepNoise` from its own generator (the
    row shapes of ``cm``, a single model or a stack)."""
    cdt, fdt, dev = cm.cdtype, cm.dtype, cm.device
    R = settings.rho_grid_size
    n = (WHITE_STEPS,)
    nw = max(len(cm.idx.white), 1)
    scale = blocks._scale_choice(gen, n, cdt, dev)
    jpos = torch.randint(0, nw, n, generator=gen, device=dev)
    eps = blocks._normal(gen, n, cdt, dev)
    logu = torch.log(blocks._uniform(gen, n, cdt, dev))
    g_red = blocks._gumbel(gen, tuple(cm.red_rho_ix_x.shape[-2:]) + (R,),
                           fdt, dev)
    if blocks._rho_invcdf_applies(cm):
        rho = torch.rand((cm.K,), generator=gen, dtype=cdt, device=dev)
    else:
        rho = blocks._gumbel(gen, (cm.K, R), fdt, dev)
    z = blocks._normal(gen, (cm.P, cm.Bmax), cdt, dev)
    return scale, jpos, eps, logu, g_red, rho, z


def sweep_noise(cm, gens) -> SweepNoise:
    """Each row's noise from its own generator, stacked over rows."""
    rows = [row_noise(cm, g) for g in gens]
    cols = list(zip(*rows))
    return SweepNoise(*[torch.stack(v, dim=1 if i < 4 else 0)
                        for i, v in enumerate(cols)])


def mux_sweep_core(cm, x, b, noise, white_ind=None, collapse=False):
    """One sweep of every tenant row of the stack ``cm`` from ``(x, b)``
    ((T, nx), (T, P, Bmax)) with ``noise`` (:class:`SweepNoise`): the
    JAX ``sharded_sweep_step``'s white MH (3 steps), red free-spectrum
    draw, common rho draw and exact b draw.  ``white_ind`` is the white
    coordinates as a device tensor (``cm.idx.white`` when None).
    Returns ``(x, b)``."""
    ind = cm.idx.white if white_ind is None else white_ind
    if len(ind):
        r2 = blocks.residual_sq(cm, b)
        x, _ = blocks.mh_scan_core(
            cm, x, lambda q: blocks.lnlike_white_per(cm, q, r2).sum(-1),
            ind, noise.scale, noise.jpos, noise.eps, noise.logu)
    x = blocks.red_conditional_update_core(cm, x, b, noise.g_red)
    if blocks._rho_invcdf_applies(cm):
        x = blocks.rho_invcdf_core(cm, x, b, noise.rho)
    else:
        x = blocks.rho_update_core(cm, x, b, noise.rho, collapse=collapse)
    b = blocks.draw_b_fn_core(cm, x, noise.z, b)
    return x, b


def tenant_seed(service_seed, tenant_id, generation=0) -> int:
    """64-bit base seed of a tenant's stream; a forked generation folds
    its salted counter on top (generation 0 folds nothing)."""
    s = stream_seed(service_seed, tenant_id)
    if int(generation):
        s = stream_seed(s, GEN_SALT + int(generation))
    return s


def sweep_seed(base, iteration) -> int:
    """Seed of absolute iteration ``iteration`` of the stream ``base``."""
    return stream_seed(base, iteration)


def init_b(cm, x, seed):
    """A fresh tenant's b: one exact conditional draw of the unstacked
    model ``cm`` at ``x`` (nx,), its normals from ``seed`` (the reserved
    iteration :data:`INIT_ITERATION`).  Returns (P, Bmax) float64 on the
    host."""
    gen = torch.Generator(cm.device).manual_seed(seed)
    xt = torch.as_tensor(np.asarray(x, np.float64)[None], dtype=cm.cdtype,
                         device=cm.device)
    z = blocks._normal(gen, (1, cm.P, cm.Bmax), cm.cdtype, cm.device)
    b = blocks.draw_b_fn_core(cm, xt, z)
    return b[0].cpu().numpy().astype(np.float64)


class MuxProgram:
    """The multiplexed chunk of one (bucket, signature) group at one slot
    count and chunk length: the tenant stack, the carries ``x`` (T, nx)
    and ``b`` (T, P, Bmax), the chunk's records ``xs`` (chunk, T, nx) and
    ``bs`` (chunk, T, P, Bmax), one generator per slot, all static; on a
    CUDA device the sweep is captured once as a CUDA graph (at the first
    sweep run) and every later sweep replays it.  ``captures`` counts
    the captures (0 or 1)."""

    def __init__(self, canon, slots, chunk):
        self.slots, self.chunk = int(slots), int(chunk)
        self.device = canon.device
        self.stack = stack_models([canon] * self.slots)
        T, cdt, dev = self.slots, canon.cdtype, canon.device
        self.x = torch.zeros((T, canon.nx), dtype=cdt, device=dev)
        self.b = torch.zeros((T, canon.P, canon.Bmax), dtype=cdt,
                             device=dev)
        self.xs = torch.zeros((self.chunk,) + tuple(self.x.shape),
                              dtype=cdt, device=dev)
        self.bs = torch.zeros((self.chunk,) + tuple(self.b.shape),
                              dtype=cdt, device=dev)
        self.gens = [torch.Generator(dev) for _ in range(T)]
        self.white_ind = torch.as_tensor(
            np.asarray(canon.idx.white, np.int64), device=dev)
        self.collapse = blocks._rho_collapsed_applies(canon)
        self.rho_ix = canon.idx.rho
        self.rho_lo = 0.5 * math.log10(canon.rhomin)
        self.rho_hi = 0.5 * math.log10(canon.rhomax)
        self.graph = None
        self.captures = 0
        #: kernel launches the capture recorded ``{(kernel, form): n}``
        self.captured_launches = {}
        self.replays = 0

    def load(self, t, cm, x, b) -> None:
        """Put model ``cm`` with state ``(x, b)`` into slot ``t`` (in
        place: the captured graph reads the same tensors)."""
        load_row(self.stack, t, cm)
        self.x[t].copy_(torch.as_tensor(np.asarray(x), dtype=self.x.dtype))
        self.b[t].copy_(torch.as_tensor(np.asarray(b), dtype=self.b.dtype))

    def _sweep(self):
        noise = sweep_noise(self.stack, self.gens)
        x, b = mux_sweep_core(self.stack, self.x, self.b, noise,
                              self.white_ind, self.collapse)
        self.x.copy_(x)
        self.b.copy_(b)

    def _capture(self):
        """Warm the sweep up on a side stream, then capture it with every
        slot's generator registered (a capture failure raises).  The
        carries are restored after the warm-up; the caller re-seeds the
        generators before the first replay."""
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch cannot register a generator with a CUDA "
                "graph (CUDAGraph.register_generator_state)")
        x0, b0 = self.x.clone(), self.b.clone()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self._sweep()
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize(self.device)
        g = torch.cuda.CUDAGraph()
        for gen in self.gens:
            g.register_generator_state(gen)
        before = kernels.launch_counts()
        with torch.cuda.graph(g, stream=stream):
            self._sweep()
        after = kernels.launch_counts()
        self.captured_launches = {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}
        torch.cuda.synchronize(self.device)
        self.x.copy_(x0)
        self.b.copy_(b0)
        self.graph = g
        self.captures += 1

    def run(self, seeds):
        """Run the chunk: before sweep ``s`` slot ``t``'s generator is
        seeded with ``seeds[s][t]``; every sweep's state is recorded.
        Returns ``(xs, bs, health)`` on the device (``health``:
        :func:`~..runtime.sentinels.chunk_health` per row)."""
        cuda = self.device.type == "cuda"
        for s in range(self.chunk):
            for gen, sd in zip(self.gens, seeds[s]):
                gen.manual_seed(int(sd))
            if cuda:
                if self.graph is None:
                    self._capture()
                    for gen, sd in zip(self.gens, seeds[s]):
                        gen.manual_seed(int(sd))
                self.graph.replay()
                self.replays += 1
            else:
                self._sweep()
            self.xs[s].copy_(self.x)
            self.bs[s].copy_(self.b)
        health = chunk_health(self.xs, self.bs, self.rho_ix, self.rho_lo,
                              self.rho_hi)
        return self.xs, self.bs, health


class ProgramCache:
    """Canonical models and multiplexed programs, keyed by (bucket, model
    signature) and (bucket, signature, slots, chunk).  ``hits`` /
    ``misses`` count admissions that found / created a canonical entry
    (the ``warm_hit_rate`` gauge)."""

    def __init__(self):
        self._canon: dict = {}
        self._programs: dict = {}
        self.hits = 0
        self.misses = 0

    def adopt(self, bucket, cm):
        """Register ``cm`` under its (bucket, signature), verified against
        the canonical model when one exists.  Returns ``(cm, warm)``."""
        key = (bucket, model_signature(cm))
        canon = self._canon.get(key)
        if canon is None:
            self._canon[key] = cm
            self.misses += 1
            return cm, False
        adopt_static(cm, canon)
        self.hits += 1
        return cm, True

    def has_bucket(self, bucket) -> bool:
        """Whether any canonical model exists for ``bucket``: the
        admission controller's warmth probe (bucket granularity: the
        signature needs a build to learn, the bucket does not)."""
        return any(k[0] == bucket for k in self._canon)

    def canonical(self, bucket, cm):
        """The canonical model sharing ``cm``'s program (the inert filler
        rows of a partly occupied stack)."""
        return self._canon[(bucket, model_signature(cm))]

    def program(self, key, slots, chunk) -> MuxProgram:
        """The group ``key``'s program at ``slots`` x ``chunk``, made
        once."""
        pkey = (key, int(slots), int(chunk))
        prog = self._programs.get(pkey)
        if prog is None:
            canon = self._canon[key]
            prog = self._programs[pkey] = MuxProgram(canon, slots, chunk)
        return prog

    def captures(self) -> int:
        """The programs' graph captures, summed."""
        return sum(p.captures for p in self._programs.values())

    def warm_hit_rate(self) -> float:
        tot = self.hits + self.misses
        return (self.hits / tot) if tot else 0.0
