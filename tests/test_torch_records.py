"""The port's chain records in the JAX layout.

Against the JAX package on one 3-pulsar model built by it and carried
across with ``from_arrays``: ``chain_shapes`` (the thinned row layout,
the chains axis dropped at one chain), ``b_param_names`` (also of the
port's own build, at equal and unequal common/red bin counts) and the
flat b layout ``_b_flat`` are equal, exactly.  Within the port: a
``record_every = 2`` run's rows are, bitwise, the rows of the
``record_every = 1`` run at the recorded iterations (streams are pure in
the iteration, so thinning changes the record, never the process), and
``record_every`` must divide ``chunk_size``.

The record precision, as the JAX package's: with ``"f32"`` (the default)
every recorded b row is ``np.float32`` of the b carry at its iteration,
as every x row is of the x carry (the post-warmup row is exact); with
``"bf16"`` the carries are bitwise the f32 run's, the rows agree with the
bfloat16 rounding of the f32 rows to
``tests/test_jax_backend.py::test_record_precision_bf16``'s class, a
resume within a bf16 run is bitwise, ``PTGIBBS_RECORD`` sets the default
and ``"f16"`` raises ``ValueError``.
"""

import numpy as np
import pytest
import torch

from test_torch_cases import jax_compiled, jax_fields, jax_pta, small_psrs

torch.set_num_threads(2)


def _port_model(psrs, nbins=4, red_bins=4, pad=None):
    from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays

    cmj = jax_compiled(psrs, nbins, red_bins, pad_pulsars=pad)
    fields = dict(jax_fields(cmj), pulsars=[p.name for p in psrs])
    return cmj, from_arrays(fields, device="cpu")


@pytest.mark.parametrize("warmup,record_every,nchains", [
    (0, 1, 4), (3, 1, 1), (5, 2, 4), (4, 4, 1), (1, 2, 2)])
def test_chain_shapes_match_jax(warmup, record_every, nchains):
    from pulsar_timing_gibbsspec_torch.sampler.driver import TorchGibbsDriver
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import \
        PTABlockGibbs as JaxGibbs

    psrs = small_psrs()
    _, cm = _port_model(psrs)
    jg = JaxGibbs(jax_pta(psrs), backend="jax", nchains=nchains, seed=0,
                  progress=False, warmup_sweeps=warmup,
                  record_every=record_every, chunk_size=8)
    drv = TorchGibbsDriver(cm, nchains=nchains, warmup_sweeps=warmup,
                           record_every=record_every, chunk_size=8)
    assert drv.nb_total == jg._backend.nb_total
    for niter in (1, 2, 3, warmup + 1, warmup + 2, warmup + 9, 37, 100):
        assert drv.chain_shapes(niter) == jg._backend.chain_shapes(niter), \
            niter
        assert drv._it_base(niter) == jg._backend._it_base(niter)


@pytest.mark.parametrize("nbins,red_bins", [(4, 4), (3, 5), (5, 3)])
def test_b_param_names_match_jax(nbins, red_bins):
    from pulsar_timing_gibbsspec_torch import build_crn_spectrum
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import \
        PTABlockGibbs as JaxGibbs

    psrs = small_psrs()
    _, cm = _port_model(psrs, nbins, red_bins)
    jg = JaxGibbs(jax_pta(psrs, nbins, red_bins), backend="jax", nchains=2,
                  progress=False, chunk_size=8)
    want = jg.b_param_names
    assert cm.b_param_names() == want
    assert build_crn_spectrum(psrs, nbins, red_bins,
                              device="cpu").b_param_names() == want
    assert len(want) == jg._backend.nb_total


def test_b_param_names_need_pulsar_names():
    from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays

    cm = from_arrays(jax_fields(jax_compiled(small_psrs())), device="cpu")
    with pytest.raises(ValueError, match="pulsar names"):
        cm.b_param_names()


@pytest.mark.parametrize("pad", [None, 4])
def test_b_flat_matches_jax(pad):
    from pulsar_timing_gibbsspec_torch.sampler.driver import TorchGibbsDriver
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import \
        PTABlockGibbs as JaxGibbs

    psrs = small_psrs()
    cmj, cm = _port_model(psrs, pad=pad)
    jg = JaxGibbs(jax_pta(psrs), backend="jax", nchains=3, progress=False,
                  chunk_size=8, pad_pulsars=pad)
    b = np.random.default_rng(3).standard_normal((5, 3, cm.P, cm.Bmax))
    got = TorchGibbsDriver(cm, nchains=3)._b_flat(b)
    assert np.array_equal(got, jg._backend._b_flat(b))
    assert got.shape == (5, 3, sum(cm.widths))


def test_thinned_rows_are_rows_of_the_full_record(tmp_path):
    from pulsar_timing_gibbsspec_torch import (PTABlockGibbs,
                                               build_crn_spectrum)

    cm = build_crn_spectrum(small_psrs(), 4, 4, device="cpu")
    out = {}
    for k in (1, 2):
        g = PTABlockGibbs(cm, nchains=2, device="cpu", seed=3,
                          warmup_sweeps=3, white_adapt_iters=120,
                          chunk_size=8, record_every=k)
        x0 = g.initial_sample(torch.Generator().manual_seed(1))
        out[k] = (g.sample(x0, outdir=tmp_path / str(k), niter=21),
                  g.bchain)
    (c1, b1), (c2, b2) = out[1], out[2]
    # warmup iterations 0, 2; the post-warmup row; steady 4, 6, .., 20
    rows = [0, 2, 3] + list(range(4, 21, 2))
    assert c2.shape[0] == len(rows)
    assert np.array_equal(c2, c1[rows]) and np.array_equal(b2, b1[rows])


def test_record_every_must_divide_the_chunk():
    from pulsar_timing_gibbsspec_torch import build_crn_spectrum
    from pulsar_timing_gibbsspec_torch.sampler.driver import TorchGibbsDriver

    cm = build_crn_spectrum(small_psrs(), 4, 4, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        TorchGibbsDriver(cm, record_every=3, chunk_size=8)
    with pytest.raises(ValueError, match="cuda"):
        TorchGibbsDriver(cm, graphs=True)


def _rec_gibbs(cm, **kw):
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs

    return PTABlockGibbs(cm, nchains=2, device="cpu", seed=9,
                         warmup_sweeps=3, white_adapt_iters=120, chunk_size=4,
                         progress=False, **kw)


@pytest.fixture(scope="module")
def rec_model():
    from pulsar_timing_gibbsspec_torch import build_crn_spectrum

    cm = build_crn_spectrum(small_psrs(), 4, 4, device="cpu")
    x0 = _rec_gibbs(cm).initial_sample(torch.Generator().manual_seed(6))
    return cm, x0


def test_f32_records_are_the_float32_carry(rec_model, tmp_path):
    cm, x0 = rec_model
    g = _rec_gibbs(cm)
    drv = g.driver
    run, carries = drv.run, {}

    def watched(*args):
        for upto in run(*args):
            # the state entering iteration it_cur (= upto: record_every 1)
            carries[upto] = (drv.x_cur.copy(),
                             drv._b_flat(drv.b.numpy()).copy())
            yield upto

    drv.run = watched
    chain = g.sample(x0, outdir=tmp_path, niter=22, save_every=4)
    bchain = g.bchain
    assert sorted(carries) == [4, 8, 12, 16, 20, 22]
    for row, (x, b) in carries.items():
        if row < 22:
            assert np.array_equal(bchain[row], b.astype(np.float32)), row
            assert np.array_equal(chain[row], x.astype(np.float32)), row
    # every row but the exact post-warmup one (3) is a float32 value
    rows = [r for r in range(22) if r != 3]
    for arr in (chain, bchain):
        assert np.array_equal(arr[rows], arr[rows].astype(np.float32))
    assert not np.array_equal(bchain[3], bchain[3].astype(np.float32))


def test_record_precision_bf16(rec_model, tmp_path, monkeypatch):
    cm, x0 = rec_model
    g32 = _rec_gibbs(cm)
    c32 = g32.sample(x0, outdir=tmp_path / "f32", niter=30, save_every=8)
    g16 = _rec_gibbs(cm, record_precision="bf16")
    assert g16.driver.rdtype == torch.bfloat16
    c16 = g16.sample(x0, outdir=tmp_path / "bf16", niter=30, save_every=8)
    # the process is unchanged: the carries are bitwise equal
    assert np.array_equal(g16.driver.x_cur, g32.driver.x_cur)
    assert torch.equal(g16.driver.b, g32.driver.b)
    # the record agrees to bf16 quantization (1-ulp slack for double
    # rounding)
    for a32, a16 in ((c32, c16), (g32.bchain, g16.bchain)):
        ref = torch.as_tensor(a32, dtype=torch.float32).to(
            torch.bfloat16).double().numpy()
        close = np.isclose(a16, ref, rtol=2.0 ** -7, atol=1e-30)
        assert close.mean() > 0.9999, 1 - close.mean()
        rows = [r for r in range(30) if r != 3]
        assert not np.array_equal(a16[rows], a32[rows])
    # resume is bitwise within a bf16 run
    ga = _rec_gibbs(cm, record_precision="bf16")
    ga.sample(x0, outdir=tmp_path / "split", niter=19, save_every=8)
    gb = _rec_gibbs(cm, record_precision="bf16")
    resumed = gb.sample(x0, outdir=tmp_path / "split", niter=30,
                        save_every=8, resume=True)
    assert np.array_equal(resumed, c16)
    assert np.array_equal(gb.bchain, g16.bchain)
    with pytest.raises(ValueError, match="record_precision"):
        _rec_gibbs(cm, record_precision="f16")
    monkeypatch.setenv("PTGIBBS_RECORD", "bf16")
    assert _rec_gibbs(cm).driver.rdtype == torch.bfloat16
    monkeypatch.setenv("PTGIBBS_RECORD", "f16")
    with pytest.raises(ValueError, match="record_precision"):
        _rec_gibbs(cm)
