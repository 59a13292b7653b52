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
