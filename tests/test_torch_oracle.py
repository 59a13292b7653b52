"""The port's NumPy oracle (``backend="numpy"``) against the JAX
package's.

Both oracles run on one model: the JAX ``NumpyGibbs`` / ``NumpyPTAGibbs``
on the JAX host model, the port's on the compiled model carried across
with ``from_arrays`` (the JAX model's float64 basis, residuals, TOA
variances and static prior variances under ``host``), from the same
start and the same ``numpy`` seed.  Their chain rows and b agree draw for
draw (rtol 1e-10; on these models they are bitwise), for one pulsar
(basis ECORR) and for the 3-pulsar array (common and red free spectra),
also after the JAX oracle's adaptation state is carried across.  The
facade: ``backend="numpy"`` runs, resumes bitwise and writes the JAX
layout with ``layout.backend == "numpy"``, refuses the driver's options
by name, ``with_backend`` drops them, and the oracle adopts a checkpoint
of the port's driver.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_cases import (jax_fields, jax_pta, jax_single_pta,
                              nanograv_psr, small_psrs)

from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays
from pulsar_timing_gibbsspec_torch.sampler.host_model import HostPTA

torch.set_num_threads(2)

RTOL = 1e-10
ADAPT = dict(white_adapt_iters=200, red_adapt_iters=200)


def _host_of(pta, cmj):
    """The JAX host model's float64 arrays of each pulsar: basis (at the
    compiled width), residuals, TOA variances, static prior variances."""
    x0 = pta.initial_sample(np.random.default_rng(0))
    phis = pta.get_phi(x0)
    out = dict(T=[], y=[], sigma2=[], phi_base=[])
    for ii, w in enumerate(cmj.widths):
        m = pta.model(ii)
        out["T"].append(np.asarray(m.get_basis()[:, :w], np.float64))
        out["y"].append(np.asarray(m.pulsar.residuals, np.float64))
        out["sigma2"].append(np.asarray(m.pulsar.toaerrs, np.float64) ** 2)
        base = np.asarray(cmj.phi_base[ii, :w])
        out["phi_base"].append(np.where(base == 0, 0.0, phis[ii][:w]))
    return out


def _carried(pta):
    """``(jax_compiled, port host view)`` of the JAX host model ``pta``."""
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    cmj = compile_pta(pta)
    cm = from_arrays(dict(jax_fields(cmj), pulsars=list(pta.pulsars),
                          host=_host_of(pta, cmj)), device="cpu")
    return cmj, HostPTA(cm.arrays)


def _case(which):
    """``(jax host model, JAX oracle class, port oracle class)``."""
    if which == "single":
        from pulsar_timing_gibbsspec_torch.sampler.numpy_backend import \
            NumpyGibbs
        from pulsar_timing_gibbsspec_tpu.sampler.numpy_backend import \
            NumpyGibbs as JaxNumpyGibbs

        return jax_single_pta(nanograv_psr()), JaxNumpyGibbs, NumpyGibbs
    from pulsar_timing_gibbsspec_torch.sampler.numpy_pta import NumpyPTAGibbs
    from pulsar_timing_gibbsspec_tpu.sampler.numpy_pta import \
        NumpyPTAGibbs as JaxNumpyPTAGibbs

    return jax_pta(small_psrs()), JaxNumpyPTAGibbs, NumpyPTAGibbs


def _flat(b):
    return np.concatenate(b) if isinstance(b, list) else np.asarray(b)


def _same(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("which", ["single", "array"])
def test_oracle_matches_the_jax_oracle_draw_for_draw(which):
    pta, JaxCls, PortCls = _case(which)
    _, hv = _carried(pta)
    jo = JaxCls(pta, seed=3, **ADAPT)
    po = PortCls(hv, seed=3, **ADAPT)
    assert po.nb_total == jo.nb_total
    xj = xp = pta.initial_sample(np.random.default_rng(1))
    for it in range(6):
        xj = jo.sweep(xj, first=it == 0)
        xp = po.sweep(xp, first=it == 0)
        _same(xp, xj)
        _same(_flat(po.b), _flat(jo.b))
    assert po.aclength_white == jo.aclength_white
    assert po.aclength_ecorr == jo.aclength_ecorr


@pytest.mark.parametrize("which", ["single", "array"])
def test_oracle_takes_the_jax_oracle_state_across(which):
    """The JAX oracle's ``adapt_state()`` loaded into the port's oracle
    continues as the JAX oracle's own continuation does."""
    pta, JaxCls, PortCls = _case(which)
    _, hv = _carried(pta)
    jo = JaxCls(pta, seed=5, **ADAPT)
    x = pta.initial_sample(np.random.default_rng(2))
    for it in range(3):
        x = jo.sweep(x, first=it == 0)
    po = PortCls(hv, seed=99, **ADAPT)
    po.load_adapt_state(jo.adapt_state())
    xj = xp = x
    for _ in range(3):
        xj, xp = jo.sweep(xj), po.sweep(xp)
        _same(xp, xj)
        _same(_flat(po.b), _flat(jo.b))


# ---- the facade --------------------------------------------------------------

@pytest.fixture(scope="module")
def cm1():
    from pulsar_timing_gibbsspec_torch import model_general

    return model_general([nanograv_psr()], red_var=False, white_vary=True,
                         common_psd="spectrum", common_components=4,
                         device="cpu")


def _np_facade(cm, **kw):
    from pulsar_timing_gibbsspec_torch import PulsarBlockGibbs

    return PulsarBlockGibbs(cm, backend="numpy", progress=False,
                            white_adapt_iters=200, **kw)


def test_numpy_backend_runs_resumes_and_writes_the_jax_layout(cm1,
                                                              tmp_path):
    """The JAX package's ``test_facade.py`` single-pulsar run-and-resume
    on the port: the chain files, a resume that extends the chain
    bitwise (seed ignored), the uninterrupted run equal to the split
    one, ``layout.backend == "numpy"`` in the manifest and in
    ``chain.h5``."""
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    g = _np_facade(cm1, seed=99)
    assert g.backend_name == "numpy"
    x0 = g.initial_sample(torch.Generator().manual_seed(1))[0]
    full = _np_facade(cm1, seed=99).sample(x0, outdir=tmp_path / "full",
                                           niter=40, save_every=20)
    out = tmp_path / "split"
    g.sample(x0, outdir=out, niter=20, save_every=20, hdf5=True)
    chain, bchain = np.load(out / "chain.npy"), np.load(out / "bchain.npy")
    assert chain.shape == (20, len(g.param_names))
    assert bchain.shape == (20, cm1.widths[0])
    assert (out / "pars_chain.txt").read_text().split() == g.param_names
    assert ((out / "pars_bchain.txt").read_text().split()
            == g.b_param_names)
    rep = integrity.verify(out)
    assert rep["ok"] and rep["rows"] == 20
    layout = json.loads((out / "manifest.json").read_text())["layout"]
    assert layout["backend"] == "numpy" and layout["nchains"] == 1
    import h5py

    with h5py.File(out / "chain.h5") as fh:
        assert fh.attrs["backend"] == "numpy"
    resumed = _np_facade(cm1, seed=7).sample(x0, outdir=out, niter=40,
                                             save_every=20, resume=True)
    assert np.array_equal(resumed, full)
    assert np.array_equal(resumed[:20], chain)


@pytest.mark.parametrize("opt", [dict(record_precision="bf16"),
                                 dict(record_every=2), dict(chunk_size=4),
                                 dict(nchains=2)])
def test_numpy_backend_refuses_device_options(cm1, opt):
    (name, _), = opt.items()
    with pytest.raises(ValueError, match=name):
        _np_facade(cm1, **opt)


def test_host_view_refuses_arrays_without_host(cm1):
    """The oracle reads the float64 ``host`` arrays or nothing: never the
    storage-dtype basis or the clipped timing-model variance."""
    arrays = {k: v for k, v in cm1.arrays.items() if k != "host"}
    with pytest.raises(ValueError, match="host"):
        HostPTA(arrays)


def test_with_backend_drops_the_device_options(cm1):
    from pulsar_timing_gibbsspec_torch import PulsarBlockGibbs

    g = PulsarBlockGibbs(cm1, nchains=2, device="cpu", seed=4,
                         progress=False, record_precision="bf16",
                         chunk_size=4, exact_every=8, white_adapt_iters=150,
                         red_steps=7)
    tw = g.with_backend("numpy")
    assert type(tw) is PulsarBlockGibbs and tw.backend_name == "numpy"
    assert tw.driver.C == 1 and tw.driver.g.white_adapt_iters == 150
    assert tw.driver.g.red_steps == 7
    same = g.with_backend("torch")
    assert same.backend_name == "torch" and same.driver.C == 2
    assert same.driver.exact_every == 8 and same.driver.chunk_size == 4


def test_oracle_adopts_a_torch_checkpoint(cm1, tmp_path):
    """A checkpoint of the port's driver (one chain) resumed on the
    oracle: the saved rows stay, the first resumed row is the driver's
    carry ``x_cur``, b is drawn again, the run goes on finite and inside
    the priors, and the continuation is seeded by ``(seed, it_cur)``."""
    from pulsar_timing_gibbsspec_torch import PulsarBlockGibbs

    kw = dict(device="cpu", seed=2, progress=False, warmup_sweeps=3,
              white_adapt_iters=150, chunk_size=5)
    g = PulsarBlockGibbs(cm1, **kw)
    x0 = g.initial_sample(torch.Generator().manual_seed(0))[0]
    out = tmp_path / "ck"
    head = g.sample(x0, outdir=out, niter=15, save_every=5)
    with np.load(out / "adapt.npz") as a:
        x_cur = a["x_cur"][0]
    runs = []
    for sub in ("a", "b"):
        d = tmp_path / sub
        import shutil

        shutil.copytree(out, d)
        nd = g.with_backend("numpy")
        runs.append(nd.sample(x0, outdir=d, niter=25, save_every=5,
                              resume=True))
    chain = runs[0]
    assert np.array_equal(chain[:15], head)
    assert np.array_equal(chain[15], x_cur)
    assert np.array_equal(runs[0], runs[1])
    assert np.isfinite(chain).all()
    rho = chain[15:, cm1.idx.rho]
    assert (rho > -10).all() and (rho < -4).all()
    assert not np.array_equal(chain[16], chain[15])
