"""The alternative correlated-ORF b-draws (``PTGIBBS_HD_KERNEL=pulsar``
and ``freq``): the port's pulsar-wise and frequency-block sweeps against
the JAX package's on the CPU, on the JAX-drawn noise, and the driver's
choice between them.

The model is ``bench.py``'s HD model cut to the 3 synthetic pulsars of
``small_psrs`` and 4 bins (P Bmax = 96, past ``HD_DENSE_MAX`` = 64, so
the choice applies), padded to 4 pulsars, the pad row of b holding a
marker.  Tolerance classes (``rel`` as in ``test_torch_hd.py``):

- float64 (``exact``) sweeps: rel 1e-10 (measured 1e-12: both Grams are
  float32 segment products of each side's float32 ``N``), Fourier
  columns 1e-4 (measured 3e-6);
- two-float sweeps: rel 1e-9, Fourier columns 1e-4, the classes of
  ``test_torch_hd.py``'s mixed joint draw (measured 2.5e-12, 6e-6);
- the pad pulsar's b, the refusal message: equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_cases import small_psrs, t64
from test_torch_hd import C, HD, hd_state, rel, rel_gp

torch.set_num_threads(2)

MARK = 7.25
#: the cases: ORF (hd: one G shared by the chains; bin_orf: one per
#: chain), float64 or two-float
CASES = [("hd", True), ("hd", False), ("bin_orf", True)]


def models(orf):
    """``(jax_cm, port_cm)`` padded to 4 pulsars."""
    import dataclasses

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    jp = [Pulsar(**dataclasses.asdict(p)) for p in small_psrs()]
    kw = {**HD, "orf": orf}
    return (compile_pta(model_general(jp, **kw), pad_pulsars=4),
            ptt.model_general(small_psrs(), device="cpu", pad_pulsars=4,
                              **kw))


def start(cmj, cmt, seed):
    """A state (each chain's ORF weights in [-0.3, 0.3] where sampled)
    and a float64 JAX draw of b there, the pad row set to ``MARK``."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    x = hd_state(cmt, seed)
    if cmt.orf_B is not None:
        ix = cmt.orf_par_ix.numpy()
        x[:, ix] = np.random.default_rng(seed).uniform(-0.3, 0.3,
                                                       (C, len(ix)))
    b = np.array(jax.vmap(lambda x, k: jb.draw_b_joint_structured(
        cmj, x, k, exact=True))(jnp.asarray(x), jr.split(jr.PRNGKey(seed),
                                                          C)))
    b[:, 3] = MARK
    return x, b


def check(cmt, bt, bj, ok, exact):
    assert bool(ok.all())
    assert rel(bt, bj) < (1e-10 if exact else 1e-9)
    assert rel_gp(cmt, bt, bj) < 1e-4
    assert bool((bt[:, 3] == MARK).all())


@pytest.mark.parametrize("orf,exact", CASES)
def test_sequential_matches_jax(orf, exact):
    """``draw_b_hd_sequential_core`` per chain equals JAX's
    ``draw_b_hd_sequential`` vmapped over the chains, at the JAX-drawn
    normals and pulsar order; the pad pulsar keeps its b bitwise."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models(orf)
    x, b = start(cmj, cmt, 31)

    def one(x, b, k):
        kz, kp = jr.split(k)
        return (jb.draw_b_hd_sequential(cmj, x, b, k, exact=exact),
                jr.normal(kz, (cmj.P, cmj.Bmax), cmj.cdtype),
                jr.permutation(kp, cmj.P))

    bj, z, perm = jax.jit(jax.vmap(one))(
        jnp.asarray(x), jnp.asarray(b), jr.split(jr.PRNGKey(32), C))
    bt, ok = blocks.draw_b_hd_sequential_core(
        cmt, t64(x), t64(b), t64(np.asarray(z)),
        torch.tensor(np.asarray(perm), dtype=torch.int64), exact=exact)
    check(cmt, bt, np.asarray(bj), ok, exact)


@pytest.mark.parametrize("orf,exact", CASES)
def test_freqblock_matches_jax(orf, exact):
    """``draw_b_hd_freqblock_core`` (the red columns folded into each
    frequency's joint step: 4 groups) per chain equals JAX's
    ``draw_b_hd_freqblock`` vmapped over the chains, at the JAX-drawn
    normals and frequency order; the pad pulsar keeps its b bitwise."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models(orf)
    m = blocks._freq_groups(cmt)
    assert m == 4
    x, b = start(cmj, cmt, 33)

    def one(x, b, k):
        kz1, kz2, kp = jr.split(k, 3)
        return (jb.draw_b_hd_freqblock(cmj, x, b, k, exact=exact),
                jr.normal(kz1, (cmj.P, cmj.Bmax), cmj.cdtype),
                jr.normal(kz2, (cmj.K, m * cmj.P), cmj.cdtype),
                jr.permutation(kp, cmj.K))

    bj, z1, z2, perm = jax.jit(jax.vmap(one))(
        jnp.asarray(x), jnp.asarray(b), jr.split(jr.PRNGKey(34), C))
    bt, ok = blocks.draw_b_hd_freqblock_core(
        cmt, t64(x), t64(b), t64(np.asarray(z1)), t64(np.asarray(z2)),
        torch.tensor(np.asarray(perm), dtype=torch.int64), exact=exact)
    check(cmt, bt, np.asarray(bj), ok, exact)


def test_breakdown_guards_keep_b():
    """A non-finite step leaves its coefficients as they were and reports
    the chain: a NaN normal in one chain's pulsar (pulsar-wise sweep) or
    one chain's frequency (frequency-block sweep)."""
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    _, cmt = models("hd")
    x = t64(hd_state(cmt, 35))
    gen = torch.Generator().manual_seed(36)
    b = torch.randn((C, cmt.P, cmt.Bmax), dtype=torch.float64, generator=gen)
    z = torch.randn((C, cmt.P, cmt.Bmax), dtype=torch.float64, generator=gen)
    perm = torch.arange(cmt.P).expand(C, -1)
    z[1, 0, 0] = float("nan")
    bs, ok = blocks.draw_b_hd_sequential_core(cmt, x, b, z, perm)
    assert ok.tolist() == [True, False, True]
    assert torch.equal(bs[1, 0], b[1, 0]) and not torch.equal(bs[1, 1],
                                                              b[1, 1])
    z1 = torch.randn((C, cmt.P, cmt.Bmax), dtype=torch.float64, generator=gen)
    z2 = torch.randn((C, cmt.K, 4 * cmt.P), dtype=torch.float64,
                     generator=gen)
    z2[2, 1] = float("nan")
    kperm = torch.arange(cmt.K).expand(C, -1)
    bf, ok = blocks.draw_b_hd_freqblock_core(cmt, x, b, z1, z2, kperm)
    assert ok.tolist() == [True, True, False]
    cols = torch.stack([cmt.gw_sin_ix[:, 1], cmt.gw_cos_ix[:, 1]], -1)
    kept = torch.gather(bf[2], -1, cols)
    assert torch.equal(kept, torch.gather(b[2], -1, cols))
    assert torch.isfinite(bf).all() and torch.isfinite(bs).all()


def test_kernel_choice(monkeypatch):
    """``PTGIBBS_HD_KERNEL`` is read when the driver is built: ``pulsar``
    and ``freq`` apply past ``HD_DENSE_MAX`` coefficients and ``joint``
    below it (and on the CRN model, no correlated draw at all); another
    value raises the JAX package's ``ValueError``, word for word."""
    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    _, cmt = models("hd")
    assert cmt.P * cmt.Bmax > blocks.HD_DENSE_MAX == 64
    for kern in ("joint", "pulsar", "freq"):
        monkeypatch.setenv("PTGIBBS_HD_KERNEL", kern)
        assert ptt.PTABlockGibbs(cmt, device="cpu").driver.hd_kernel == kern
    monkeypatch.setattr(blocks, "HD_DENSE_MAX", cmt.P * cmt.Bmax)
    assert ptt.PTABlockGibbs(cmt, device="cpu").driver.hd_kernel == "joint"
    crn = ptt.build_crn_spectrum(small_psrs(), 4, 4, device="cpu")
    assert ptt.PTABlockGibbs(crn, device="cpu").driver.hd_kernel is None
    monkeypatch.setenv("PTGIBBS_HD_KERNEL", "dense")
    with pytest.raises(ValueError) as port:
        ptt.PTABlockGibbs(cmt, device="cpu")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.run(
        [sys.executable, "-c", "import pulsar_timing_gibbsspec_tpu.sampler."
         "jax_backend"], env=env, capture_output=True, text=True)
    assert ref.returncode != 0
    assert f"ValueError: {port.value}" in ref.stderr


@pytest.mark.parametrize("kern", ["pulsar", "freq"])
def test_sampler_resume_and_kernel_in_layout(tmp_path, monkeypatch, kern):
    """``PTABlockGibbs`` under each alternative draw: 2 chains, 3 warmup
    and 24 steady sweeps in chunks of 8 (the two-float sweep, float64 at
    16); every record finite, no draw skipped a pulsar or a frequency; a
    run split at row 12 and resumed writes ``chain.npy`` and
    ``bchain.npy`` bitwise equal to the whole run's; the checkpoint's
    layout names the draw, and a resume under the other one raises."""
    import json

    import pulsar_timing_gibbsspec_torch as ptt

    monkeypatch.setenv("PTGIBBS_HD_KERNEL", kern)
    cm = ptt.model_general(small_psrs(), white_vary=True, device="cpu",
                           **{k: v for k, v in HD.items()
                              if k != "white_vary"})
    niter = 3 + 1 + 24

    def gibbs():
        return ptt.PTABlockGibbs(cm, nchains=2, device="cpu", seed=5,
                                 warmup_sweeps=3, white_adapt_iters=60,
                                 chunk_size=8, progress=False)

    x0 = gibbs().initial_sample(torch.Generator().manual_seed(2))
    whole = gibbs()
    whole.sample(x0, outdir=tmp_path / "whole", niter=niter)
    assert whole.driver.b_joint_breakdowns.tolist() == [0, 0]
    assert whole.driver.kept_by_stage == dict(init=0, warmup=0, adaptation=0)
    gibbs().sample(x0, outdir=tmp_path / "split", niter=12)
    manifest = json.loads((tmp_path / "split" / "manifest.json").read_text())
    assert manifest["layout"]["hd_kernel"] == kern
    other = "freq" if kern == "pulsar" else "pulsar"
    monkeypatch.setenv("PTGIBBS_HD_KERNEL", other)
    with pytest.raises(RuntimeError, match="PTGIBBS_HD_KERNEL"):
        gibbs().sample(x0, outdir=tmp_path / "split", niter=niter,
                       resume=True)
    monkeypatch.setenv("PTGIBBS_HD_KERNEL", kern)
    gibbs().sample(x0, outdir=tmp_path / "split", niter=niter, resume=True)
    for nm in ("chain.npy", "bchain.npy"):
        a = np.load(tmp_path / "whole" / nm)
        assert np.isfinite(a).all()
        assert np.array_equal(a, np.load(tmp_path / "split" / nm)), nm
