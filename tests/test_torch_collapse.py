"""The partially collapsed common-rho draw (``PTGIBBS_RHO_COLLAPSE=1``)
against the JAX package's.

The predicate ``_rho_collapsed_applies`` equals the JAX one on four
models (a CRN with a sampled free-spectrum red on the common columns:
true; the same with its red amplitudes constant, the Hellings-Downs
array, a powerlaw red: false).  On JAX-drawn Gumbels the port's
collapsed ``rho_update_core`` draws the JAX ``rho_update``'s grid points
(with ``RHO_COLLAPSE`` patched on, as ``tests/test_jax_backend.py``
runs it), and its log-PDF table is the float64 quadrature within the
float32 class (1e-4 of the table's scale).  The driver puts rho before
the red draw in the warmup and steady sweeps as the JAX sweep bodies do
(their calls recorded while tracing them), and a checkpoint refuses a
resume under the other setting.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from test_torch_cases import (jax_fields, jax_pta, models, small_psrs,
                              state)

from pulsar_timing_gibbsspec_torch.sampler import blocks
from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays

torch.set_num_threads(2)


def _jax_model(kind):
    """``(jax_cm, port_cm)`` of one of the four predicate cases."""
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    if kind in ("crn", "constant_red"):
        cmj, cm = models()
        if kind == "constant_red":
            # every red amplitude a constant: the sentinel nx in x
            sent = np.full_like(np.asarray(cmj.red_rho_ix_x), cmj.nx)
            cmj = dataclasses.replace(cmj, red_rho_ix_x=sent)
            cm = dataclasses.replace(cm, red_rho_ix_x=torch.as_tensor(sent))
        return cmj, cm
    jp = [Pulsar(**dataclasses.asdict(p)) for p in small_psrs()]
    opts = dict(tm_svd=True, white_vary=True, common_psd="spectrum",
                common_components=4, red_var=True, red_components=4)
    if kind == "hd":
        opts.update(red_psd="spectrum", orf="hd")
    else:
        opts.update(red_psd="powerlaw")
    cmj = compile_pta(model_general(jp, **opts))
    return cmj, from_arrays(jax_fields(cmj), device="cpu")


@pytest.mark.parametrize("kind,want", [("crn", True),
                                       ("constant_red", False),
                                       ("hd", False), ("powerlaw", False)])
def test_predicate_matches_jax(kind, want, monkeypatch):
    import pulsar_timing_gibbsspec_tpu.sampler.jax_backend as jb

    monkeypatch.setattr(jb, "RHO_COLLAPSE", True)
    cmj, cm = _jax_model(kind)
    assert jb._rho_collapsed_applies(cmj) is want
    assert blocks._rho_collapsed_applies(cm, True) is want
    assert blocks._rho_collapsed_applies(cm, False) is False
    monkeypatch.setenv("PTGIBBS_RHO_COLLAPSE", "1")
    assert blocks._rho_collapsed_applies(cm) is want


def _f64_table(cm, tau, grid):
    """The collapsed conditional (K, R) in float64 NumPy, straight from
    its formula (one chain)."""
    J = blocks.RHO_COLLAPSE_J
    redg = 10.0 ** np.linspace(math.log10(cm.red_rhomin),
                               math.log10(cm.red_rhomax), J)
    samp = (cm.red_rho_ix_x < cm.nx).numpy()
    out = np.zeros((cm.K, len(grid)))
    for p in range(cm.P_real):
        for k in range(cm.K):
            if k < samp.shape[1] and samp[p, k]:
                lr = np.log(tau[p, k]) - np.log(grid[:, None] + redg)
                a = lr - np.exp(lr)
                m = a.max(-1, keepdims=True)
                out[k] += (m[:, 0] + np.log(np.exp(a - m).sum(-1))
                           - math.log(J))
            else:
                lp = np.log(tau[p, k]) - np.log(grid)
                out[k] += lp - np.exp(lp)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collapsed_core_on_jax_gumbels(seed, monkeypatch):
    import jax.numpy as jnp
    import jax.random as jr

    import pulsar_timing_gibbsspec_tpu.sampler.jax_backend as jb

    monkeypatch.setattr(jb, "RHO_COLLAPSE", True)
    cmj, cm = models()
    x = state(cm, seed=seed)
    rng = np.random.default_rng(10 + seed)
    b = rng.normal(size=(cm.P, cm.Bmax)) * 10.0 ** rng.uniform(-8, -6.5)
    key = jr.key(seed)
    want = np.asarray(jb.rho_update(cmj, jnp.asarray(x), jnp.asarray(b),
                                    key))
    gum = torch.as_tensor(np.array(jr.gumbel(
        key, (cmj.K, 1000), dtype=jnp.float32)))
    got = blocks.rho_update_core(cm, torch.as_tensor(x), torch.as_tensor(b),
                                 gum, collapse=True).numpy()
    rix = cm.rho_ix_x.numpy()
    # the same grid points: the grid is 0.003 apart in x, the written
    # values one float32 rounding apart
    np.testing.assert_allclose(got[rix], want[rix], rtol=0, atol=1e-5)
    assert np.array_equal(np.delete(got, rix), np.delete(want, rix))
    grid = blocks._rho_grid(cm, cm.rhomin, cm.rhomax)
    ltau = torch.log(cm.gw_tau(torch.as_tensor(b))).to(cm.dtype)
    table = blocks._rho_collapsed_logpdf(cm, ltau, grid).numpy()
    ref = _f64_table(cm, cm.gw_tau(torch.as_tensor(b)).numpy(),
                     grid.double().numpy())
    scale = np.abs(ref).max()
    np.testing.assert_allclose(table, ref, rtol=0, atol=1e-4 * scale)


def test_chunked_profile_equals_one_chunk(monkeypatch):
    """The grid chunks that bound the transient change no value."""
    _, cm = models()
    rng = np.random.default_rng(4)
    b = torch.as_tensor(rng.normal(size=(3, cm.P, cm.Bmax)) * 1e-7)
    grid = blocks._rho_grid(cm, cm.rhomin, cm.rhomax)
    ltau = torch.log(cm.gw_tau(b)).to(cm.dtype)
    whole = blocks._rho_collapsed_logpdf(cm, ltau, grid)
    monkeypatch.setattr(blocks, "RHO_COLLAPSE_CHUNK_BYTES", 100_000)
    assert torch.equal(blocks._rho_collapsed_logpdf(cm, ltau, grid), whole)


_JAX_NAMES = {"rho_update": "rho", "red_conditional_update": "red",
              "rho_scale_moves": "scale"}


def test_block_order_matches_jax(monkeypatch):
    """rho before red in the warmup and steady sweeps of both drivers,
    and the switch recorded in the stream options."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    import pulsar_timing_gibbsspec_tpu.sampler.jax_backend as jb
    from pulsar_timing_gibbsspec_torch.sampler.driver import TorchGibbsDriver

    monkeypatch.setattr(jb, "RHO_COLLAPSE", True)
    calls = []
    for name in _JAX_NAMES:
        fn = getattr(jb, name)

        def wrap(*a, _fn=fn, _name=name, **k):
            calls.append(_JAX_NAMES[_name])
            return _fn(*a, **k)

        monkeypatch.setattr(jb, name, wrap)
    jd = jb.JaxGibbsDriver(jax_pta(small_psrs()), seed=0, nchains=1)
    cmj = jd.cm
    x, b = jnp.zeros(cmj.nx), jnp.zeros((cmj.P, cmj.Bmax))
    u = jnp.zeros((cmj.P, cmj.Nmax))
    orders = []
    for make in (jd._warmup_body, jd._sweep_body):
        calls.clear()
        body = make()
        jax.eval_shape(lambda x, b, u, k: body(
            (x, b, u), k, (None,) * 11, jnp.int32(0)), x, b, u, jr.key(0))
        orders.append(list(calls))
    assert orders[0] == orders[1] == ["rho", "red", "scale"]

    _, cm = models()
    monkeypatch.setenv("PTGIBBS_RHO_COLLAPSE", "1")
    drv = TorchGibbsDriver(cm, seed=0)
    assert drv.rho_collapse
    assert drv._hyper_blocks() == orders[1]
    assert drv.stream_options()["rho_collapse"] == 1
    monkeypatch.setenv("PTGIBBS_RHO_COLLAPSE", "0")
    off = TorchGibbsDriver(cm, seed=0)
    assert not off.rho_collapse and off._hyper_blocks() == [
        "red", "rho", "scale"]


def test_collapsed_run_and_its_resume(tmp_path, monkeypatch):
    """A short collapsed run on the CPU is finite and inside its priors,
    resumes bitwise, and a resume with the switch off raises."""
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs, build_crn_spectrum

    cm = build_crn_spectrum(small_psrs(), 4, 4, device="cpu")
    kw = dict(nchains=2, device="cpu", seed=3, warmup_sweeps=3,
              white_adapt_iters=100, chunk_size=5, progress=False)
    monkeypatch.setenv("PTGIBBS_RHO_COLLAPSE", "1")
    g = PTABlockGibbs(cm, **kw)
    x0 = g.initial_sample(torch.Generator().manual_seed(0))
    full = g.sample(x0, outdir=tmp_path / "full", niter=30, save_every=10)
    assert np.isfinite(full).all()
    rho = full[..., cm.idx.rho]
    assert (rho >= -10).all() and (rho <= -4).all()
    PTABlockGibbs(cm, **kw).sample(x0, outdir=tmp_path / "split", niter=15,
                                   save_every=5)
    resumed = PTABlockGibbs(cm, **kw).sample(
        x0, outdir=tmp_path / "split", niter=30, save_every=10, resume=True)
    assert np.array_equal(resumed, full)
    monkeypatch.setenv("PTGIBBS_RHO_COLLAPSE", "0")
    with pytest.raises(RuntimeError, match="PTGIBBS_RHO_COLLAPSE"):
        PTABlockGibbs(cm, **kw).sample(x0, outdir=tmp_path / "split",
                                       niter=40, resume=True)
