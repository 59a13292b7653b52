"""The JAX driver's and facade's options on the port, against the JAX
package on the CPU.

One small model (the 3-pulsar array: varied white noise, red and common
free spectra, 4 bins) is sampled once by each package's
``PTABlockGibbs`` with ``exact_every=4``, ``white_steps_max=2``,
``warmup_white_steps=3`` and ``progress=True``, 2 chains, 3 warmup + 24
steady sweeps, checkpoints every 8.  Checked:

- both drivers cap the white sub-chain at 2 and take 3 steps in a
  warmup sweep; the port refreshes b on the sweeps the JAX rule ``t %
  exact_every == 0`` names;
- the progress lines (one per checkpoint when stdout is not a terminal)
  have the JAX facade's form;
- ``common_rho`` raises the JAX driver's ``ValueError`` on a model
  without a shared free spectrum (``PTABlockGibbs`` passes it);
- a resume that asks for another ``exact_every``, ``white_steps_max`` or
  ``warmup_white_steps`` raises; ``backup=False`` leaves no ``.bak``
  and a verified manifest;
- ``params`` and ``map_params`` equal the JAX facade's on models with
  scalar, vector, LinearExp and InvGamma parameters.
"""

import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest
import torch

from test_torch_cases import NBINS, jax_pta, nanograv_psr, small_psrs

import pulsar_timing_gibbsspec_torch as ptt
from pulsar_timing_gibbsspec_torch.runtime import integrity
from pulsar_timing_gibbsspec_torch.sampler import blocks
from pulsar_timing_gibbsspec_torch.sampler.driver import TorchGibbsDriver

torch.set_num_threads(2)

C, WARM, NITER, SAVE = 2, 3, 28, 8
OPTS = dict(exact_every=4, white_steps_max=2, warmup_white_steps=3)


def _port(cm=None, **kw):
    cm = cm or ptt.build_crn_spectrum(small_psrs(), NBINS, NBINS,
                                      device="cpu")
    return ptt.PTABlockGibbs(cm, nchains=C, device="cpu", seed=0,
                             warmup_sweeps=WARM, white_adapt_iters=120,
                             **dict(OPTS, **kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both facades' runs: ``(jax facade, its stdout, port facade, its
    stdout, port outdir, the port's warmup white scan lengths)``."""
    import pulsar_timing_gibbsspec_tpu.sampler.gibbs as jgibbs

    pta = jax_pta(small_psrs())
    x0 = pta.initial_sample(np.random.default_rng(0))
    jg = jgibbs.PTABlockGibbs(pta, backend="jax", nchains=C, seed=0,
                              warmup_sweeps=WARM, white_adapt_iters=120,
                              chunk_size=SAVE, **OPTS)
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        jg.sample(x0, outdir=str(tmp_path_factory.mktemp("jax")),
                  niter=NITER, save_every=SAVE)
    tg = _port(chunk_size=SAVE)
    seen = []
    scan = blocks.parallel_cov_mh_scan

    def spy(cm, x, gen, target, par_ix, nper, chol, nsteps, **kw):
        seen.append((par_ix is cm.white_par_ix, int(nsteps),
                     kw.get("record", True)))
        return scan(cm, x, gen, target, par_ix, nper, chol, nsteps, **kw)

    out = tmp_path_factory.mktemp("torch")
    tout = io.StringIO()
    blocks.parallel_cov_mh_scan = spy
    try:
        with contextlib.redirect_stdout(tout):
            tg.sample(x0, outdir=str(out), niter=NITER, save_every=SAVE)
    finally:
        blocks.parallel_cov_mh_scan = scan
    return jg, jout.getvalue(), tg, tout.getvalue(), out, seen


def test_sub_chains_and_refresh_follow_the_options(runs):
    """White sub-chains capped at 2 on both sides (the ACT is larger),
    3 steps per warmup sweep, and the refresh on the sweeps ``t`` with
    ``t % 4 == 0``."""
    jg, _, tg, _, _, seen = runs
    drv, jdrv = tg.driver, jg._backend
    assert drv.aclength_white == jdrv.aclength_white == 2
    assert (jdrv.exact_every, jdrv.white_steps_max,
            jdrv.warmup_white_steps) == (4, 2, 3)
    warm = [n for white, n, rec in seen if white and not rec]
    assert warm[:WARM] == [3] * WARM and set(warm[WARM:]) == {2}
    steady = range(drv._it_base(NITER), NITER)
    assert drv.b_refresh_sweeps == sum(t % 4 == 0 for t in steady)
    assert drv.b_mh_sweeps == sum(t % 4 != 0 for t in steady)


def test_progress_lines_match_jax(runs):
    """One line per checkpoint, ``[<backend>] rows/total rows (rate
    sweeps/s)``, on both sides."""
    _, jtxt, _, ttxt, _, _ = runs
    form = r"\[{}\] (\d+)/{} rows \(\d+\.\d sweeps/s\)"
    jrows = re.findall(form.format("jax", NITER), jtxt)
    trows = re.findall(form.format("torch", NITER), ttxt)
    assert trows == jrows and trows[-1] == str(NITER) and len(trows) >= 3
    assert len(ttxt.splitlines()) == len(trows)
    quiet = _port(progress=False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        quiet.sample(quiet.initial_sample(torch.Generator().manual_seed(1)),
                     outdir=str(runs[4].parent / "quiet"), niter=WARM + 3)
    assert buf.getvalue() == ""


def test_common_rho_matches_jax():
    """On a model whose common process is a powerlaw, ``common_rho=True``
    raises the JAX driver's ValueError, and so does ``PTABlockGibbs``."""
    from pulsar_timing_gibbsspec_tpu.sampler.jax_backend import \
        JaxGibbsDriver

    psrs = small_psrs()
    kw = dict(tm_svd=True, white_vary=True, common_psd="powerlaw",
              common_components=NBINS, red_psd="spectrum",
              red_components=NBINS)
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    pta = model_general([Pulsar(**dataclasses.asdict(p)) for p in psrs],
                        **kw)
    with pytest.raises(ValueError) as want:
        JaxGibbsDriver(pta, common_rho=True)
    cm = ptt.model_general(psrs, device="cpu", **kw)
    for make in (lambda: TorchGibbsDriver(cm, common_rho=True),
                 lambda: ptt.PTABlockGibbs(cm, device="cpu")):
        with pytest.raises(ValueError) as got:
            make()
        assert str(got.value) == str(want.value)
    assert TorchGibbsDriver(cm).do_rho is False


@pytest.mark.parametrize("key,value", [("exact_every", 8),
                                       ("white_steps_max", 3),
                                       ("warmup_white_steps", 4)])
def test_resume_with_another_stream_option_raises(runs, key, value):
    """The checkpoint records the stream options; a resume that asks
    for another value raises before sampling, one with the same values
    goes on."""
    _, _, tg, _, out, _ = runs
    with np.load(out / "adapt.npz") as z:
        assert {k: int(z[k]) for k in OPTS} == OPTS
    layout = integrity.read_manifest(out)["layout"]
    assert {k: layout[k] for k in OPTS} == OPTS
    again = _port(chunk_size=SAVE, **{key: value})
    x0 = tg.initial_sample(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match=f"{key}="):
        again.sample(x0, outdir=str(out), niter=NITER + SAVE, resume=True)


def test_backup_false_keeps_no_bak(tmp_path):
    """``sample(..., backup=False)`` writes every checkpoint without a
    ``.bak`` generation and leaves a verified manifest; the default
    keeps one."""
    for backup, out in ((False, tmp_path / "nobak"), (True, tmp_path / "bak")):
        g = _port(chunk_size=4)
        g.sample(g.initial_sample(torch.Generator().manual_seed(2)),
                 outdir=str(out), niter=WARM + 9, save_every=4,
                 backup=backup)
        assert g.store.backup is backup
        baks = [p for p in out.iterdir() if ".bak" in p.name]
        assert bool(baks) is backup
        assert integrity.verify(out)["ok"]


@pytest.mark.parametrize("which", ["array", "tprocess upper limit"])
def test_params_and_map_params_match_jax(which):
    """Names, sizes, prior classes and prior numbers of ``params``, and
    ``map_params`` of a chain vector, equal the JAX facade's."""
    import pulsar_timing_gibbsspec_tpu.sampler.gibbs as jgibbs
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    if which == "array":
        psrs = small_psrs()
        kw = dict(tm_svd=True, white_vary=True, common_psd="spectrum",
                  common_components=NBINS, red_psd="spectrum",
                  red_components=1)
        facade = "PTABlockGibbs"
    else:
        psrs = [nanograv_psr()]
        kw = dict(white_vary=True, common_psd="powerlaw",
                  common_components=NBINS, red_psd="tprocess",
                  red_components=NBINS, upper_limit=True, gequad=True)
        facade = "PulsarBlockGibbs"
    pta = model_general([Pulsar(**dataclasses.asdict(p)) for p in psrs],
                        **kw)
    jg = getattr(jgibbs, facade).__new__(getattr(jgibbs, facade))
    jg.pta = pta
    tg = getattr(ptt, facade)(ptt.model_general(psrs, device="cpu", **kw),
                              device="cpu", progress=False)
    numbers = {"Uniform": ("pmin", "pmax"), "LinearExp": ("pmin", "pmax"),
               "Normal": ("mu", "sigma"), "InvGamma": ("shape", "rate")}
    want = [(p.name, p.size, type(p).__name__,
             *(np.float32(getattr(p, a)) for a in numbers[type(p).__name__]))
            for p in jg.params]
    got = [(q.name, q.size, q.prior, np.float32(q.a), np.float32(q.b))
           for q in tg.params]
    assert got == want
    assert {q.prior for q in tg.params} >= (
        {"Uniform"} if which == "array" else {"LinearExp", "InvGamma"})
    x = np.random.default_rng(3).standard_normal(len(tg.param_names))
    mj, mt = jg.map_params(x), tg.map_params(torch.as_tensor(x))
    assert list(mj) == list(mt)
    for k in mj:
        assert type(mj[k]) is type(mt[k]) and np.array_equal(mj[k], mt[k])
