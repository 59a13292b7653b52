"""The port's kernels (plain versions on the CPU) against the JAX
package's Pallas kernels run in interpret mode, as tests/test_kernels.py
runs them, on one realistic system of the 3-pulsar model.

Tolerance classes:

- Gram, float64 accumulation (``widen``): every float32 product is exact
  in float64 on both sides; only the summation order differs, so the
  difference is within one float64 ULP class of the Jacobi scale
  ``sqrt(G_ii G_jj)`` (bound stated: 2 eps_f64).
- Gram, float32 segment products: ``~sqrt(seg_len) eps_f32`` of the
  Jacobi scale (config.py's class; bound stated: 4 sqrt(m + nseg)
  eps_f32).
- Factor chain, float64: each output within 1e-12 of its largest entry
  (the float64 sums in other orders, amplified by the system's
  conditioning).
- Factor chain, float32 (a backward-error class): against a float64
  evaluation of the same float32 inputs, the port's error is at most
  4x the JAX kernel's error plus 16 eps_f32 of the output's scale.
- Two-float refresh factor: its congruence residual class, 4 n eps_f32
  (64 n eps_f32 for the solved mean and sample).
"""

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.ops import kernels
from pulsar_timing_gibbsspec_torch.ops.kernels import build, reference
from pulsar_timing_gibbsspec_torch.sampler import blocks
from test_torch_cases import models, small_psrs, state, t64

torch.set_num_threads(2)

EPS32, EPS64 = 2.0 ** -23, 2.0 ** -52


def _system(seed=3, cmt=None):
    """(cm, Ta, N, Sig64, d64, Sig32, d32, z) of the small model (the
    JAX package's, carried across; or ``cmt``) at a seeded state, C = 2
    chains flattened into the batch: ``Ta`` (P, nseg, m, B1) on a grid of
    32-TOA segments, ``N`` (2 P, Nmax)."""
    if cmt is None:
        cmt = models()[1]
    x = t64(state(cmt, C=2, seed=seed)).to(cmt.device)
    N = cmt.ndiag_fast(x)
    Ta, Nf = blocks._gram_operands(cmt, N, 32)
    TNT, d = blocks.tnt_d(cmt, N, seg_len=32)
    phi = cmt.phi(x)
    Sig64 = TNT + torch.diag_embed(1.0 / phi)
    TNT32, d32 = blocks.tnt_d_seg32(cmt, N, seg_len=32)
    Sig32 = TNT32 + torch.diag_embed(1.0 / cmt.phi(x, dtype=torch.float32))
    B = cmt.Bmax
    z = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (2 * cmt.P, B)), device=cmt.device)
    return (cmt, Ta, Nf.reshape(-1, Nf.shape[-1]),
            Sig64.reshape(-1, B, B), d.reshape(-1, B),
            Sig32.reshape(-1, B, B), d32.reshape(-1, B), z)


def _jax_pallas_chol(Sig, d, z, ridge):
    import jax
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.ops import kernels as jk

    fn = jax.jit(lambda S, dd, zz: jk.chol_solve_sample(
        S, dd, zz, ridge=ridge, tier="pallas"))
    return [np.asarray(o) for o in fn(*map(jnp.asarray, (Sig, d, z)))]


@pytest.mark.parametrize("form", ["f32", "f32_dot_f64_reduce", "widen_f64"])
def test_gram_matches_jax_interpret(form):
    """The port's Gram of ``(Ta, N)`` against the JAX Pallas kernel on
    JAX's own ``TNa = Ta / N`` (the JAX package's operand builder)."""
    import jax
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.ops import kernels as jk
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj = models()[0]
    _, Ta, N, *_ = _system()
    P = Ta.shape[0]
    C = N.shape[0] // P
    odt = torch.float32 if form == "f32" else torch.float64
    widen = form == "widen_f64"
    got = kernels.gram_accumulate(Ta, N, out_dtype=odt, widen=widen)
    TNa_j, Ta_j = jax.jit(jax.vmap(
        lambda n: jb._gram_operands(cmj, n, 32)))(
            jnp.asarray(N.numpy().reshape(C, P, -1)))
    TNa_j = TNa_j.reshape((-1,) + TNa_j.shape[2:])
    Ta_j = Ta_j.reshape((-1,) + Ta_j.shape[2:])
    assert np.array_equal(np.asarray(Ta_j[:P]), Ta.numpy())
    ref = np.asarray(jax.jit(lambda a, b: jk.gram_accumulate(
        a, b, out_dtype=jnp.dtype(str(odt).split(".")[1]), widen=widen,
        tier="pallas"))(TNa_j, Ta_j))
    assert got.dtype == odt and got.shape == ref.shape
    dg = np.sqrt(np.diagonal(ref.astype(np.float64), axis1=1, axis2=2))
    scale = dg[:, :, None] * dg[:, None, :]
    diff = np.abs(got.numpy().astype(np.float64) - ref)
    assert np.all(diff[scale == 0] == 0)      # pad columns: exact zeros
    err = diff / np.where(scale > 0, scale, 1.0)
    nseg, m = Ta.shape[1], Ta.shape[2]
    tol = 2 * EPS64 if widen else 4 * np.sqrt(m + nseg) * EPS32
    assert err.max() <= tol, (form, err.max(), tol)


def test_gram_shared_operand_rule():
    """Row b of N pairs with pulsar b % P of the per-pulsar Ta: the same
    bits as an explicitly repeated Ta, and as one call per chain."""
    _, Ta, N, *_ = _system()
    P = Ta.shape[0]
    rep = Ta.repeat(N.shape[0] // P, 1, 1, 1)
    for kw in (dict(out_dtype=torch.float32), dict(out_dtype=torch.float64),
               dict(out_dtype=torch.float64, widen=True)):
        got = kernels.gram_accumulate(Ta, N, **kw)
        assert torch.equal(got, kernels.gram_accumulate(rep, N, **kw))
        per_chain = torch.cat([kernels.gram_accumulate(Ta, Nc, **kw)
                               for Nc in N.split(P)])
        assert torch.equal(got, per_chain)
    with pytest.raises(ValueError):
        reference.gram_accumulate_ref(Ta, N[:P - 1])


def _gram_materialized(TNa, Ta, out_dtype, widen):
    """The plain Gram as it took a materialized ``TNa``: float32 (or
    widened) per-segment products, reduced in segment order."""
    nb, Pt = TNa.shape[0], Ta.shape[0]
    A = TNa.reshape((nb // Pt, Pt) + TNa.shape[1:])
    acc = None
    for s in range(Ta.shape[1]):
        a, b = A[..., s, :, :], Ta[..., s, :, :]
        if widen:
            part = torch.matmul(a.to(out_dtype).transpose(-1, -2),
                                b.to(out_dtype))
        else:
            part = torch.matmul(a.transpose(-1, -2), b).to(out_dtype)
        acc = part if acc is None else acc + part
    return acc.reshape((nb,) + acc.shape[2:])


@pytest.mark.parametrize("seg_len", [11, 32, 120])
def test_fused_plain_gram_equals_materialized(seg_len):
    """The fused plain version equals the Gram of a materialized ``TNa =
    Ta / N`` (zero-padded to the segment grid) bit for bit, with pad rows
    (``Nmax`` not a multiple of the segment length) and the shared
    operand (row b of N with pulsar b % P)."""
    cmt, *_ = _system()
    x = t64(state(cmt, C=3, seed=11))
    Nv = cmt.ndiag_fast(x)
    Ta, N = blocks._gram_operands(cmt, Nv, seg_len)
    P, nseg, m, B1 = Ta.shape
    Nmax = N.shape[-1]
    Tf = torch.cat([cmt.T, cmt.y[..., None]], dim=-1)
    TNa = torch.nn.functional.pad(Tf / N[..., None],
                                  (0, 0, 0, nseg * m - Nmax))
    TNa = TNa.reshape(-1, nseg, m, B1)
    assert torch.equal(reference.gram_operand(Ta, N.reshape(-1, Nmax)),
                       TNa)
    for odt, widen in ((torch.float32, False), (torch.float64, False),
                       (torch.float64, True)):
        got = kernels.gram_accumulate(Ta, N.reshape(-1, Nmax),
                                      out_dtype=odt, widen=widen)
        assert torch.equal(got, _gram_materialized(TNa, Ta, odt, widen))
    if seg_len == 11:
        assert nseg * m > Nmax        # the grid has pad rows


def test_chol_solve_sample_f64_matches_jax_interpret():
    _, _, _, Sig, d, _, _, z = _system()
    got = kernels.chol_solve_sample(Sig, d, z, ridge=4e-6)
    ref = _jax_pallas_chol(Sig.numpy(), d.numpy(), z.numpy(), 4e-6)
    for name, g, r in zip(("L", "Li", "dj", "mean", "bp"), got, ref):
        scale = np.abs(r).max()
        assert np.abs(g.numpy() - r).max() <= 1e-12 * scale, name


def test_chol_solve_sample_f32_error_class():
    _, _, _, _, _, Sig, d, z = _system()
    z32 = z.to(torch.float32)
    got = kernels.chol_solve_sample(Sig, d, z32, ridge=4e-6)
    ref = _jax_pallas_chol(Sig.numpy(), d.numpy(), z32.numpy(), 4e-6)
    exact = reference.chol_solve_sample_ref(
        Sig.double(), d.double(), z32.double(), ridge=4e-6)
    for name, g, r, e in zip(("L", "Li", "dj", "mean", "bp"), got, ref,
                             exact):
        assert g.dtype == torch.float32
        e = e.numpy()
        ep = np.abs(g.numpy().astype(np.float64) - e).max()
        ej = np.abs(r.astype(np.float64) - e).max()
        assert ep <= 4 * ej + 16 * EPS32 * np.abs(e).max(), (name, ep, ej)


def test_tf_factor_runs_the_plain_version():
    """factor="tf" (the refresh) is the plain two-float chain on either
    device.  Its accuracy class is the congruence residual
    ``||Li A Li^T - I|| ~ n eps_f32`` (ops/linalg.tf_chol_factor), so the
    port is held to 4 n eps_f32 there, and to the JAX package's outputs
    within 4 n eps_f32 of each output's largest entry (64 n eps_f32 for
    the solved mean and sample)."""
    import jax
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.ops.kernels import reference as jref

    _, _, _, Sig, d, _, _, z = _system()
    n = Sig.shape[-1]
    got = kernels.chol_solve_sample(Sig, d, z, ridge=4e-6, factor="tf")
    same = reference.chol_solve_sample_ref(Sig, d, z, ridge=4e-6,
                                           factor="tf")
    for g, s in zip(got, same):
        assert torch.equal(g, s)
    L, Li, dj = got[:3]
    A = Sig * dj[:, :, None] * dj[:, None, :]
    resid = Li @ A @ Li.transpose(-1, -2) - torch.eye(n, dtype=A.dtype)
    assert resid.abs().max().item() <= 4 * n * EPS32
    ref = jax.jit(lambda S, dd, zz: jref.chol_solve_sample_ref(
        S, dd, zz, ridge=4e-6, factor="tf"))(
            *map(jnp.asarray, (Sig.numpy(), d.numpy(), z.numpy())))
    for name, g, r in zip(("L", "Li", "dj", "mean", "bp"), got, ref):
        r = np.asarray(r)
        # the solves carry the residual into the soft directions, up to
        # sqrt(cond) ~ 16x in the largest entry
        k = 64 if name in ("mean", "bp") else 4
        tol = k * n * EPS32 * np.abs(r).max()
        assert np.abs(g.numpy() - r).max() <= tol, name
    with pytest.raises(ValueError):
        kernels.chol_solve_sample(Sig, d, z, factor="qr")


def test_cpu_tensors_never_build_or_launch():
    """A CPU tensor runs the plain version: nothing is built and no
    launch is counted."""
    kernels.reset_launches()
    _, Ta, N, Sig, d, *_ = _system()
    kernels.gram_accumulate(Ta, N)
    kernels.chol_solve_sample(Sig, d, d)
    assert build._lib is None
    assert kernels.gram_accumulate.launches == 0
    assert kernels.chol_solve_sample.launches == 0
    assert not any(kernels.device_launches().values())


def test_cpu_sampler_blocks_never_build_or_launch():
    """The sampler's Gram and factor entries on CPU tensors (every Gram
    form, the steady factor) reach neither the kernel library nor a
    launch count, whatever the sizes the kernels would refuse."""
    kernels.reset_launches()
    cmt, Ta, N, Sig, d, Sig32, d32, z = _system()
    x = t64(state(cmt, C=2, seed=4))
    Nv = cmt.ndiag_fast(x)
    for fn in (blocks.tnt_d, blocks.tnt_d_seg, blocks.tnt_d_seg32):
        G, dd = fn(cmt, Nv)
        assert G.device.type == "cpu" and torch.isfinite(G).all()
    blocks._factor_batch(Sig32, d32, z.float(), ridge=4e-6)
    wide = torch.zeros(1, 1, 1, kernels.GRAM_MAX_B1 + 1)
    kernels.gram_accumulate(wide, torch.ones(2, 1))
    big = torch.eye(kernels.CHOL_MAX_N + 1)[None]
    kernels.chol_solve_sample(big, big[:, 0], big[:, 0])
    assert build._lib is None
    assert kernels.gram_accumulate.launches == 0
    assert kernels.chol_solve_sample.launches == 0
    assert not any(kernels.gram_accumulate.form_launches.values())
    assert not any(kernels.chol_solve_sample.form_launches.values())


def _gram_f64_close_on_card(Ta, N):
    """The float64-operand form (float64 storage) on float64 copies of
    ``(Ta, N)`` against its plain version on the card, at the Jacobi
    scale: within 2 (m + nseg) eps_f64 (float64 products round)."""
    nseg, m = Ta.shape[1], Ta.shape[2]
    k = kernels.gram_accumulate(Ta.double(), N.double())
    p = reference.gram_accumulate_ref(Ta.double(), N.double())
    dg = torch.sqrt(torch.diagonal(p, dim1=1, dim2=2))
    scale = dg[:, :, None] * dg[:, None, :]
    err = ((k - p).abs() / torch.where(scale > 0, scale, 1.0)).max().item()
    assert k.dtype == torch.float64
    assert err <= 2 * (m + nseg) * EPS64, (tuple(Ta.shape), err)


def _gram_close_on_card(Ta, N):
    """Every Gram form against its plain version on the card, at the
    Jacobi scale: float32 products within 8 sqrt(m + nseg) eps_f32,
    widened float64 and the float64-operand form within 2 (m + nseg)
    eps_f64."""
    _gram_f64_close_on_card(Ta, N)
    nseg, m = Ta.shape[1], Ta.shape[2]
    for odt, widen in ((torch.float32, False), (torch.float64, False),
                       (torch.float64, True)):
        k = kernels.gram_accumulate(Ta, N, out_dtype=odt, widen=widen)
        p = reference.gram_accumulate_ref(Ta, N, out_dtype=odt, widen=widen)
        dg = torch.sqrt(torch.diagonal(p.double(), dim1=1, dim2=2))
        scale = dg[:, :, None] * dg[:, None, :]
        err = ((k.double() - p.double()).abs()
               / torch.where(scale > 0, scale, 1.0)).max().item()
        tol = (2 * (m + nseg) * EPS64 if widen
               else 8 * np.sqrt(m + nseg) * EPS32)
        assert err <= tol, (tuple(Ta.shape), odt, widen, err)


def _chol_close_on_card(Sig, d, z):
    """The float64 factor within 1e-10 of the float64 chain's scale; the
    float32 factor's error against a float64 evaluation of the same
    float32 inputs at most 8x the plain float32 chain's plus 64 eps_f32
    of the output's scale."""
    k = kernels.chol_solve_sample(Sig, d, z, ridge=4e-6)
    p = reference.chol_solve_sample_ref(Sig, d, z, ridge=4e-6)
    for a, b in zip(k, p):
        assert (a - b).abs().max().item() <= 1e-10 * b.abs().max().item()
    Sig32, d32, z32 = Sig.float(), d.float(), z.float()
    k = kernels.chol_solve_sample(Sig32, d32, z32, ridge=4e-6)
    p = reference.chol_solve_sample_ref(Sig32, d32, z32, ridge=4e-6)
    e = reference.chol_solve_sample_ref(Sig32.double(), d32.double(),
                                        z32.double(), ridge=4e-6)
    for a, b, c in zip(k, p, e):
        ek = (a.double() - c).abs().max().item()
        ep = (b.double() - c).abs().max().item()
        assert ek <= 8 * ep + 64 * EPS32 * c.abs().max().item(), (
            tuple(Sig.shape), ek, ep)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_the_card():
    """On a card: every kernel form against its plain version (run on
    the card too), on the small model and on seeded shapes that cover
    the kernels' edges: Gram widths B1 in {8, 38, 64} with 5 chains (a
    ragged last group of chains per CTA), a segment grid with pad rows
    (nonzero Ta there, which TNa must zero) and segments longer than one
    pipeline stage; factor orders n in {1, 2, 31, 32, 33, 37, 64} with 7
    systems (a ragged last CTA), both element types.  Needs no JAX, so it
    runs on a machine without it:
    ``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested above)")
    from pulsar_timing_gibbsspec_torch import build_crn_spectrum

    cmt, Ta, N, Sig, d, Sig32, d32, z = _system(
        cmt=build_crn_spectrum(small_psrs(), 4, 4, device="cuda"))
    _gram_close_on_card(Ta, N)
    _chol_close_on_card(Sig, d, z)

    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    P, C = 3, 5
    for B1 in (8, 38, 64):
        for Nmax, nseg, m in ((101, 4, 26), (150, 2, 75)):
            Ta = rng.standard_normal((P, nseg * m, B1)).astype(np.float32)
            N = rng.uniform(0.25, 4.0, (C * P, Nmax)).astype(np.float32)
            _gram_close_on_card(
                torch.as_tensor(Ta.reshape(P, nseg, m, B1), device=dev),
                torch.as_tensor(N, device=dev))
    # a zero N on a pad row of one chain: 0 / 0 makes that chain's Gram
    # NaN in the plain version, so the kernel may not skip the row
    Ta = rng.standard_normal((P, 4 * 26, 38)).astype(np.float32)
    Ta[0, 60:] = 0.0
    N = rng.uniform(0.25, 4.0, (C * P, 101)).astype(np.float32)
    N[P, 80] = 0.0
    Ta, N = (torch.as_tensor(v, device=dev) for v in (Ta.reshape(P, 4, 26, 38),
                                                     N))
    for odt, widen in ((torch.float32, False), (torch.float64, False),
                       (torch.float64, True)):
        k = kernels.gram_accumulate(Ta, N, out_dtype=odt, widen=widen)
        p = reference.gram_accumulate_ref(Ta, N, out_dtype=odt, widen=widen)
        assert p[P].isnan().any() and not p[0].isnan().any()
        assert torch.equal(k.isnan(), p.isnan())
    _gram_close_on_card(Ta, N[:P])
    for n in (1, 2, 31, 32, 33, 37, 64):
        batch = 7
        X = rng.standard_normal((batch, n, n))
        D = 10.0 ** rng.uniform(-2, 2, (batch, n))
        A = X @ X.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
        Sig = D[:, :, None] * A * D[:, None, :]
        _chol_close_on_card(
            *(torch.as_tensor(v, device=dev) for v in (
                Sig, rng.standard_normal((batch, n)) * D,
                rng.standard_normal((batch, n)))))
    assert kernels.gram_accumulate.launches >= 3 * 9
    assert kernels.chol_solve_sample.launches >= 2 * 8


def _gram_equal_on_card(Ta, N):
    """Every float32-operand Gram form bitwise equal to its plain version
    on the card: within a segment each output is one FMA chain over the
    TOA rows in index order, and segments are added in order, on both
    sides; the float64-operand form in its class."""
    _gram_f64_close_on_card(Ta, N)
    for odt, widen in ((torch.float32, False), (torch.float64, False),
                       (torch.float64, True)):
        k = kernels.gram_accumulate(Ta, N, out_dtype=odt, widen=widen)
        p = reference.gram_accumulate_ref(Ta, N, out_dtype=odt, widen=widen)
        assert torch.equal(k, p), (tuple(Ta.shape), tuple(N.shape), odt,
                                   widen, (k - p).abs().max().item())


def _spd_case(rng, batch, n):
    """A seeded ``(Sig, d, z)`` on the card: a well-conditioned SPD
    matrix under a diagonal scaling spanning four decades."""
    X = rng.standard_normal((batch, n, n))
    D = 10.0 ** rng.uniform(-2, 2, (batch, n))
    A = X @ X.transpose(0, 2, 1) / n + 0.5 * np.eye(n)
    return tuple(torch.as_tensor(v, device="cuda") for v in (
        D[:, :, None] * A * D[:, None, :], rng.standard_normal((batch, n)) * D,
        rng.standard_normal((batch, n))))


@pytest.mark.cuda
def test_wide_kernels_match_plain_on_the_card():
    """On a card: the wide forms (n > CHOL_MAX_N, B1 > GRAM_MAX_B1)
    against their plain versions, the Gram bitwise and the factor (both
    element types) in the narrow forms' class above, at the single-pulsar
    path's shape (README's Quick-start model of the J1713+0747 snapshot,
    30 bins: 8 systems of order 673, Ta (1, 8, 90, 674)) and at the
    redesign's edges: Gram widths B1 in {65, 129, 136, 674, 1024} (one
    output tile and a ragged last tile of each form's tiling), 3 chains
    of 2 pulsars, segments of 40 rows (not a multiple of the 16-row
    stage) on a grid with pad rows, one pulsar whose rows end before
    Nmax; batches of 1 and 64; factor orders n in {97, 128, 129, 160,
    1024} (a one-row last panel at 129, 97 and 673) at 5 systems, and
    batches of 1 and 64; each wide form counted on the card.  Needs no
    JAX: ``python -m pytest --noconftest -m cuda
    tests/test_torch_kernels.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested above)")
    import os

    from pulsar_timing_gibbsspec_torch import model_general
    from pulsar_timing_gibbsspec_torch.config import settings
    from pulsar_timing_gibbsspec_torch.data import load_enterprise_snapshot

    dev = torch.device("cuda")
    psr = load_enterprise_snapshot(os.path.join(
        os.path.dirname(__file__), "data", "enterprise_J1713+0747.npz"))
    cm = model_general([psr], red_var=False, white_vary=True,
                       common_psd="spectrum", common_components=30,
                       device=dev)
    assert cm.Bmax == 673
    C = 8
    x = t64(state(cm, C=C, seed=11)).to(dev)
    kernels.reset_launches()
    Ta, N = blocks._gram_operands(cm, cm.ndiag_fast(x),
                                  settings.gram_seg_len)
    _gram_equal_on_card(Ta, N.reshape(-1, N.shape[-1]))
    TNT, d = blocks.tnt_d(cm, cm.ndiag_fast(x))
    Sig = TNT + torch.diag_embed(1.0 / cm.phi(x))
    z = torch.randn(d.shape, generator=torch.Generator(dev).manual_seed(1),
                    dtype=torch.float64, device=dev)
    _chol_close_on_card(Sig.reshape(-1, 673, 673), d.reshape(-1, 673),
                        z.reshape(-1, 673))
    rng = np.random.default_rng(12)
    for B1 in (65, 129, 136, 674, 1024):
        Tn = rng.standard_normal((2, 2 * 40, B1)).astype(np.float32)
        Tn[1, 50:] = 0.0               # pulsar 1's rows end at row 50
        Nn = rng.uniform(0.25, 4.0, (6, 75)).astype(np.float32)
        _gram_equal_on_card(
            torch.as_tensor(Tn.reshape(2, 2, 40, B1), device=dev),
            torch.as_tensor(Nn, device=dev))
    for batch, B1 in ((1, 136), (64, 129)):
        Tn = rng.standard_normal((1, 2 * 40, B1)).astype(np.float32)
        Nn = rng.uniform(0.25, 4.0, (batch, 75)).astype(np.float32)
        _gram_equal_on_card(
            torch.as_tensor(Tn.reshape(1, 2, 40, B1), device=dev),
            torch.as_tensor(Nn, device=dev))
    for batch, n in ((5, 97), (5, 128), (5, 129), (5, 160), (5, 1024),
                     (1, 129), (64, 160)):
        _chol_close_on_card(*_spd_case(rng, batch, n))
    runs = kernels.device_launches()
    for key in [("chol_solve_sample", f) for f in ("f32_wide", "f64_wide")] \
            + [("gram_accumulate", f + "_wide") for f in kernels.GRAM_FORMS]:
        assert runs[key] > 0, key
    assert runs[("chol_solve_sample", "f32")] == 0
    assert runs[("gram_accumulate", "f32")] == 0
