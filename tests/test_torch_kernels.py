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
    """(cm, TNa, Ta, Sig64, d64, Sig32, d32, z) of the small model (the
    JAX package's, carried across; or ``cmt``) at a seeded state, C = 2
    chains flattened into the batch."""
    if cmt is None:
        cmt = models()[1]
    x = t64(state(cmt, C=2, seed=seed)).to(cmt.device)
    N = cmt.ndiag_fast(x)
    TNa, Ta = blocks._gram_operands(cmt, N, 32)
    TNT, d = blocks.tnt_d(cmt, N, seg_len=32)
    phi = cmt.phi(x)
    Sig64 = TNT + torch.diag_embed(1.0 / phi)
    TNT32, d32 = blocks.tnt_d_seg32(cmt, N, seg_len=32)
    Sig32 = TNT32 + torch.diag_embed(1.0 / cmt.phi(x, dtype=torch.float32))
    B = cmt.Bmax
    z = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (2 * cmt.P, B)), device=cmt.device)
    return (cmt, TNa.reshape((-1,) + TNa.shape[-3:]), Ta,
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
    import jax
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_tpu.ops import kernels as jk

    cmt, TNa, Ta, *_ = _system()
    P = Ta.shape[0]
    odt = torch.float32 if form == "f32" else torch.float64
    widen = form == "widen_f64"
    got = kernels.gram_accumulate(TNa, Ta, out_dtype=odt, widen=widen)
    Ta_full = np.tile(Ta.numpy(), (TNa.shape[0] // P, 1, 1, 1))
    ref = np.asarray(jax.jit(lambda a, b: jk.gram_accumulate(
        a, b, out_dtype=jnp.dtype(str(odt).split(".")[1]), widen=widen,
        tier="pallas"))(jnp.asarray(TNa.numpy()), jnp.asarray(Ta_full)))
    assert got.dtype == odt and got.shape == ref.shape
    dg = np.sqrt(np.diagonal(ref.astype(np.float64), axis1=1, axis2=2))
    scale = dg[:, :, None] * dg[:, None, :]
    diff = np.abs(got.numpy().astype(np.float64) - ref)
    assert np.all(diff[scale == 0] == 0)      # pad columns: exact zeros
    err = diff / np.where(scale > 0, scale, 1.0)
    nseg, m = TNa.shape[1], TNa.shape[2]
    tol = 2 * EPS64 if widen else 4 * np.sqrt(m + nseg) * EPS32
    assert err.max() <= tol, (form, err.max(), tol)


def test_gram_shared_operand_rule():
    """Row b of TNa pairs with row b % P of the per-pulsar Ta: the same
    bits as an explicitly repeated Ta."""
    _, TNa, Ta, *_ = _system()
    rep = Ta.repeat(TNa.shape[0] // Ta.shape[0], 1, 1, 1)
    for kw in (dict(out_dtype=torch.float32), dict(out_dtype=torch.float64),
               dict(out_dtype=torch.float64, widen=True)):
        assert torch.equal(kernels.gram_accumulate(TNa, Ta, **kw),
                           kernels.gram_accumulate(TNa, rep, **kw))
    with pytest.raises(ValueError):
        reference.gram_accumulate_ref(TNa[:5], Ta)


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
    _, TNa, Ta, Sig, d, *_ = _system()
    kernels.gram_accumulate(TNa, Ta)
    kernels.chol_solve_sample(Sig, d, d)
    assert build._lib is None
    assert kernels.gram_accumulate.launches == 0
    assert kernels.chol_solve_sample.launches == 0


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_the_card():
    """On a card: every kernel form against its plain version (run on
    the card too).  Needs no JAX, so it runs on a machine without it:
    ``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
    """
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (their plain versions are tested above)")
    from pulsar_timing_gibbsspec_torch import build_crn_spectrum

    cmt, TNa, Ta, Sig, d, Sig32, d32, z = _system(
        cmt=build_crn_spectrum(small_psrs(), 4, 4, device="cuda"))
    nseg, m = TNa.shape[1], TNa.shape[2]
    for odt, widen in ((torch.float32, False), (torch.float64, False),
                       (torch.float64, True)):
        k = kernels.gram_accumulate(TNa, Ta, out_dtype=odt, widen=widen)
        p = reference.gram_accumulate_ref(TNa, Ta, out_dtype=odt,
                                          widen=widen)
        dg = torch.sqrt(torch.diagonal(p.double(), dim1=1, dim2=2))
        scale = dg[:, :, None] * dg[:, None, :]
        err = ((k.double() - p.double()).abs()
               / torch.where(scale > 0, scale, 1.0)).max().item()
        tol = (2 * (m + nseg) * EPS64 if widen
               else 8 * np.sqrt(m + nseg) * EPS32)
        assert err <= tol, (odt, widen, err)
    k = kernels.chol_solve_sample(Sig, d, z, ridge=4e-6)
    p = reference.chol_solve_sample_ref(Sig, d, z, ridge=4e-6)
    for a, b in zip(k, p):
        assert (a - b).abs().max().item() <= 1e-10 * b.abs().max().item()
    z32 = z.float()
    k = kernels.chol_solve_sample(Sig32, d32, z32, ridge=4e-6)
    p = reference.chol_solve_sample_ref(Sig32, d32, z32, ridge=4e-6)
    e = reference.chol_solve_sample_ref(Sig32.double(), d32.double(),
                                        z32.double(), ridge=4e-6)
    for a, b, c in zip(k, p, e):
        ek = (a.double() - c).abs().max().item()
        ep = (b.double() - c).abs().max().item()
        assert ek <= 8 * ep + 64 * EPS32 * c.abs().max().item()
    assert kernels.gram_accumulate.launches >= 3
    assert kernels.chol_solve_sample.launches >= 2
