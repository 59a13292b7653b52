"""The Hellings-Downs array, piece by piece: the port against the JAX
package on the CPU, on the same numpy inputs and the JAX-drawn noise.

The model is ``bench.py``'s HD model cut to the 3 synthetic pulsars of
``small_psrs`` (with sky positions) and 4 frequency bins: a common free
spectrum under a correlated ORF on columns of its own, and per-pulsar
red noise.  Tolerance classes (``rel`` is ``max |a - b| / max |b|``, the
JAX package's own measure in ``tests/test_joint_structured.py``):

- model arrays, ``orf_ginv_stack`` and the refusals: equal (arrays
  field by field, messages word for word);
- block-grid Cholesky and its solves: float64 1e-12 relative to each
  output's largest entry; two-float 1e-5 (float32 factors in both
  frameworks' own operation order, one refinement step each);
- the float64 structured joint draw against JAX's at the same normals:
  rel 1e-10 (measured 7.2e-12: both Grams are float32 segment products
  of each side's float32 ``N``, which differ by an ULP of ``pow``, and
  the conditioned solve carries that into b), through both Schur
  branches; against the port's dense draw: rel 1e-8 (same matrix, same
  order; measured 4e-21).  ``rel`` is dominated by the timing-model
  columns (prior variance 1e30), so the Fourier columns (``gp_mask``)
  are also held on their own scale: 1e-4 (measured 6.4e-6);
- the mixed (two-float) draw against JAX's at the same normals: rel
  1e-9 (measured 6.5e-12, a margin of about 150), Fourier columns 1e-4
  (measured 4.4e-6);
- the factor cache, the breakdown guard: bitwise;
- the HD rho draw: the same grid point (values to 1e-5 relative: the
  float32 grids differ by an ULP between the frameworks).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_cases import (close, jax_fields, same_field, small_psrs,
                              state, t32, t64)

torch.set_num_threads(2)

NB = 4
#: model_general options of bench.py's HD model at 4 bins
HD = dict(tm_svd=True, white_vary=True, common_psd="spectrum",
          common_components=NB, red_var=True, red_psd="spectrum",
          red_components=NB, orf="hd")
#: the model cases: ORF, options beside HD's
CASES = {"hd": {}, "freq_hd": dict(orf="freq_hd", orf_ifreq=2),
         "st": dict(orf="st"), "hd_red_powerlaw": dict(red_psd="powerlaw")}
C = 3


def _opts(name):
    return {**HD, **CASES[name]}


def jax_model(name, **extra):
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    jp = [Pulsar(**dataclasses.asdict(p)) for p in small_psrs()]
    return model_general(jp, **{**_opts(name), **extra})


@functools.lru_cache(maxsize=None)
def models(name="hd"):
    """``(jax_cm, port_cm)`` of a case, the port's from its own
    ``model_general``."""
    from pulsar_timing_gibbsspec_torch import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    return (compile_pta(jax_model(name)),
            model_general(small_psrs(), device="cpu", **_opts(name)))


def hd_state(cm, seed):
    """:func:`state` for chains ``C`` with the common log10_rho near the
    synthetic array's injection, -7 +- 0.5."""
    x = state(cm, C=C, seed=seed)
    rng = np.random.default_rng(seed + 50)
    x[:, cm.rho_ix_x.numpy()] = -7.0 + rng.uniform(-0.5, 0.5, (C, cm.K))
    return x


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def rel_gp(cm, a, b):
    """``rel`` on the Fourier-GP columns alone."""
    gp = cm.gp_mask.numpy() > 0
    a, b = np.asarray(a)[..., gp], np.asarray(b)[..., gp]
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def jax_draws(cmj, x, seed, **kw):
    """JAX's structured draw per chain from keys split off ``seed``, and
    the normals it drew: ``(b, z)``."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    n = cmj.P * cmj.Bmax + 2 * cmj.K * cmj.P
    keys = jr.split(jr.PRNGKey(seed), x.shape[0])

    def one(x, k):
        return (jb.draw_b_joint_structured(cmj, x, k, **kw),
                jr.normal(k, (n,), dtype=cmj.cdtype))

    b, z = jax.jit(jax.vmap(one))(jnp.asarray(x), keys)
    return np.asarray(b), np.asarray(z)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_model_equals_compile_pta(name):
    """The port's arrays (``orf_name``, ``orf_Ginv`` with identity on a
    pad pulsar, ``red_shares_gw``, the disjoint common and red columns)
    equal ``compile_pta``'s field by field, for hd, freq_hd, st and HD
    with intrinsic powerlaw red noise; the parameter names are the JAX
    model's; the compiled port model carries the same stack."""
    from pulsar_timing_gibbsspec_torch.models.build import model_arrays
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    pta = jax_model(name)
    opts = {k: v for k, v in _opts(name).items() if k != "white_vary"}
    for pad in (None, 4):
        want = jax_fields(compile_pta(pta, pad_pulsars=pad))
        got = model_arrays(small_psrs(), pad_pulsars=pad, **opts)
        assert list(got["param_names"]) == list(pta.param_names)
        assert got["orf_Ginv"].shape == (NB, pad or 3, pad or 3)
        assert not got["red_shares_gw"]
        for key, v in want.items():
            if key == "components":
                assert len(v) == len(got[key])
                for c, d in zip(v, got[key]):
                    for k in c:
                        same_field(c[k], d[k], f"components.{k}")
            elif key in ("dtype", "cdtype"):
                assert np.dtype(v) == np.dtype(got[key])
            else:
                same_field(v, got[key], key)
    cmt = models(name)[1]
    assert cmt.orf_name == want["orf_name"]
    assert torch.equal(cmt.orf_ginv_k(), t64(want["orf_Ginv"][:, :3, :3]))
    cols, valid, ccl = cmt.gw_cols_valid()
    assert torch.equal(cols, torch.cat([cmt.gw_sin_ix, cmt.gw_cos_ix], 1))
    assert bool((valid == 1).all()) and torch.equal(cols, ccl)


@pytest.mark.parametrize("orf", ["hd", "freq_hd", "st", "gw_monopole",
                                 "gw_dipole", "monopole", "dipole",
                                 "zero_diag_hd"])
def test_orf_ginv_stack_matches_jax(orf):
    """``orf_ginv_stack`` of every fixed ORF equals the JAX package's
    (freq_hd from bin 2), and the rank-deficient and zero-diagonal ones
    are refused with its message."""
    from pulsar_timing_gibbsspec_torch.models import orf as torf
    from pulsar_timing_gibbsspec_tpu.models import orf as jorf

    pos = [p.pos for p in small_psrs()]
    outs = []
    for mod in (torf, jorf):
        try:
            outs.append(mod.orf_ginv_stack(orf, pos, NB, orf_ifreq=2))
        except NotImplementedError as e:
            outs.append(str(e))
    if isinstance(outs[1], str):
        assert outs[0] == outs[1]
    else:
        assert np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("orf,extra", [
    ("zero_diag_bin_orf", {}), ("zero_diag_legendre_orf", {}),
    ("zero_diag_hd", {}), ("hd", dict(common_psd="powerlaw")),
    ("hd,crn", {})])
def test_refusals(orf, extra):
    """What ``compile_pta`` refuses (the zero-diagonal ORFs, sampled
    weights or fixed, a powerlaw common process under HD, mixed ORFs)
    the port refuses with its message."""
    from pulsar_timing_gibbsspec_torch import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    kw = {**HD, "orf": orf, **extra}
    with pytest.raises(NotImplementedError) as port:
        model_general(small_psrs(), device="cpu", **kw)
    with pytest.raises(NotImplementedError) as ref:
        compile_pta(jax_model("hd", **{k: v for k, v in kw.items()
                                       if k != "white_vary"}))
    if "," in orf:
        assert str(port.value).startswith("mixed common-process ORFs")
        assert str(ref.value).startswith("mixed common-process ORFs")
    else:
        assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the block-grid Cholesky
# ---------------------------------------------------------------------------

def _grid_spd(m, P, seed):
    """A unit-diagonal SPD (C, m P, m P) matrix and its (C, m, m, P, P)
    grid."""
    rng = np.random.default_rng(seed)
    n = m * P
    M = rng.standard_normal((C, n, n))
    A = M @ M.transpose(0, 2, 1) + 0.5 * n * np.eye(n)
    d = 1.0 / np.sqrt(np.einsum("cii->ci", A))
    A = A * d[:, :, None] * d[:, None, :]
    S = A.reshape(C, m, P, m, P).transpose(0, 1, 3, 2, 4)
    return A, np.ascontiguousarray(S)


@pytest.mark.parametrize("mixed", [False, True])
def test_block_grid_matches_jax(mixed):
    """``block_grid_cholinv``, ``block_grid_solve_lower`` and ``_upper``
    against the JAX package's on a seeded 5 x 5 grid of 3 x 3 blocks,
    float64 (blocked_chol_inv + _mm_t) and two-float (tf_chol_factor +
    tf_mm); ``block_grid_to_dense`` equals the JAX layout, and the grid
    factor is the dense factor of that layout."""
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_torch.ops import linalg as tl
    from pulsar_timing_gibbsspec_tpu.ops import linalg as jl

    A, S = _grid_spd(5, 3, seed=4)
    r = np.random.default_rng(5).standard_normal((C, 5, 3))
    jkw = (dict(factor=jl.tf_chol_factor, mm=jl.tf_mm) if mixed
           else dict(factor=jl.blocked_chol_inv, mm=jl._mm_t))
    tkw = (dict(factor=tl.tf_chol_factor, mm=tl.tf_mm) if mixed
           else dict(factor=tl.blocked_chol_inv, mm=tl._mm_t))
    want = jl.block_grid_cholinv(jnp.asarray(S), **jkw)
    got = tl.block_grid_cholinv(t64(S), **tkw)
    tol = 1e-5 if mixed else 1e-12
    for w, g in zip(want, got):
        close(g, np.asarray(w), rtol=0, atol=tol * np.abs(w).max())
    Ldi, Loff = want[1], want[2]
    for fn in ("block_grid_solve_lower", "block_grid_solve_upper"):
        w = np.asarray(getattr(jl, fn)(Ldi, Loff, jnp.asarray(r)))
        g = getattr(tl, fn)(t64(np.asarray(Ldi)), t64(np.asarray(Loff)),
                            t64(r))
        close(g, w, rtol=0, atol=1e-12 * np.abs(w).max())
    dense = tl.block_grid_to_dense(t64(S))
    assert np.array_equal(dense.numpy(),
                          np.asarray(jl.block_grid_to_dense(jnp.asarray(S))))
    assert np.array_equal(dense.numpy(), A)
    if not mixed:
        Ld, _, Loff_t = got
        L = tl.block_grid_to_dense(Loff_t + _diag_grid(Ld))
        Ldense, _ = tl.blocked_chol_inv(t64(A))
        close(L, Ldense.numpy(), rtol=0, atol=1e-12)


def _diag_grid(Ld):
    """(..., m, P, P) diagonal blocks -> (..., m, m, P, P) grid."""
    m = Ld.shape[-3]
    out = Ld.new_zeros(Ld.shape[:-3] + (m, m) + Ld.shape[-2:])
    idx = torch.arange(m)
    out[..., idx, idx, :, :] = Ld
    return out


# ---------------------------------------------------------------------------
# the joint b-draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [False, True])
def test_structured_exact_matches_jax_and_dense(grid, monkeypatch):
    """The float64 structured draw equals JAX's at the JAX-drawn normals
    (rel 1e-10) and the port's dense draw (rel 1e-8), through the flat
    Schur factor and, with ``SCHUR_DENSE_MAX = 0`` on both sides, the
    block grid; every chain's draw is taken."""
    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    if grid:
        monkeypatch.setattr(jb, "SCHUR_DENSE_MAX", 0)
        monkeypatch.setattr(blocks, "SCHUR_DENSE_MAX", 0)
    cmj, cmt = models()
    x = hd_state(cmt, seed=1)
    bj, z = jax_draws(cmj, x, 11, exact=True)
    bt, ok = blocks.draw_b_joint_structured_core(cmt, t64(x), t64(z),
                                                 exact=True)
    assert bool(ok.all())
    assert rel(bt, bj) < 1e-10 and rel_gp(cmt, bt, bj) < 1e-4
    bd = blocks.draw_b_joint(cmt, t64(x), t64(z))
    assert rel(bt, bd) < 1e-8
    # the exact b | everything of the sampler is this draw
    assert torch.equal(blocks.draw_b_fn_core(cmt, t64(x), t64(z)), bt)


@pytest.mark.parametrize("grid", [False, True])
def test_structured_mixed_matches_jax(grid, monkeypatch):
    """The two-float draw (both stages ``tf_chol_factor``, products
    ``tf_mm``) against JAX's mixed draw at the same normals: rel 1e-9;
    and within 1e-3 of the float64 draw, the JAX package's class."""
    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    if grid:
        monkeypatch.setattr(jb, "SCHUR_DENSE_MAX", 0)
        monkeypatch.setattr(blocks, "SCHUR_DENSE_MAX", 0)
    cmj, cmt = models()
    x = hd_state(cmt, seed=2)
    bj, z = jax_draws(cmj, x, 12, exact=False, mixed=True)
    bt, ok = blocks.draw_b_joint_structured_core(cmt, t64(x), t64(z),
                                                 mixed=True)
    assert bool(ok.all())
    assert rel(bt, bj) < 1e-9 and rel_gp(cmt, bt, bj) < 1e-4
    be, _ = blocks.draw_b_joint_structured_core(cmt, t64(x), t64(z),
                                                exact=True)
    assert rel(bt, be) < 1e-3


def test_factor_cache_inert_and_breakdown_guard():
    """A draw through a precomputed ``joint_factor_cache`` equals the
    self-factoring draw bitwise (float64 and two-float); a stage-1
    factor poisoned with NaN keeps the previous b wholesale (zeros
    without one) and reports the chain; a finite draw replaces b."""
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    _, cmt = models()
    x = t64(hd_state(cmt, seed=3))
    z = torch.randn((C, blocks._joint_dim(cmt)), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    for exact in (True, False):
        f = blocks.joint_factor_cache(cmt, x, exact=exact, mixed=True)
        assert f.mixed is not exact
        a, _ = blocks.draw_b_joint_structured_core(cmt, x, z, exact=exact,
                                                   mixed=True)
        b, _ = blocks.draw_b_joint_structured_core(cmt, x, z, factors=f)
        assert torch.equal(a, b)
    f = blocks.joint_factor_cache(cmt, x, mixed=True)
    prev = torch.full((C, cmt.P, cmt.Bmax), 0.5, dtype=torch.float64)
    good, ok = blocks.draw_b_joint_structured_core(cmt, x, z, prev,
                                                   factors=f)
    assert bool(ok.all()) and torch.isfinite(good).all()
    assert not torch.equal(good, prev)
    bad = f._replace(Li1=f.Li1 * torch.where(
        torch.arange(C)[:, None, None, None] == 1, float("nan"), 1.0))
    kept, ok = blocks.draw_b_joint_structured_core(cmt, x, z, prev,
                                                   factors=bad)
    assert ok.tolist() == [True, False, True]
    assert torch.equal(kept[1], prev[1]) and torch.equal(kept[0], good[0])
    kept0, _ = blocks.draw_b_joint_structured_core(cmt, x, z, factors=bad)
    assert torch.equal(kept0[1], torch.zeros_like(kept0[1]))


def test_hd_rho_update_matches_jax():
    """The correlated-ORF rho draw (the quadratic form ``1/2 sum_phase
    a_k^T G^-1 a_k`` on the Gumbel-max grid) equals JAX's ``rho_update``
    on the JAX-drawn Gumbels, per chain; the scale moves stay off."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_torch.config import settings
    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models()
    x = hd_state(cmt, seed=5)
    b, _ = jax_draws(cmj, x, 13, exact=True)
    keys = jr.split(jr.PRNGKey(14), C)

    def one(x, b, k):
        return (jb.rho_update(cmj, x, b, k),
                jr.gumbel(k, (cmj.K, settings.rho_grid_size),
                          dtype=cmj.dtype))

    xj, gum = jax.jit(jax.vmap(one))(jnp.asarray(x), jnp.asarray(b), keys)
    xt = blocks.rho_update_core(cmt, t64(x), t64(b), t32(np.asarray(gum)))
    rix = cmt.rho_ix_x.numpy()
    close(xt[:, rix], np.asarray(xj)[:, rix], rtol=1e-5)
    others = np.setdiff1d(np.arange(cmt.nx), rix)
    assert np.array_equal(xt.numpy()[:, others], x[:, others])
    assert not blocks._rho_scale_applies(cmt)
    assert not blocks._rho_invcdf_applies(cmt)
