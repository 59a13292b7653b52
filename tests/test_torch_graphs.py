"""The steady sweep replayed from CUDA graphs, on a card.

On the small model (3 pulsars, 4 + 4 bins, 4 chains), after a short
eager run has adapted the sampler: 17 steady sweeps from one state (one
of them the refresh at iteration 16) replayed from the graphs equal the
eager sweeps bitwise in x, b and the b_mh acceptance counts (and so do
those of the single-pulsar path with basis ECORR), and a run
split at a chunk boundary and resumed through the graph path equals the
uninterrupted graphed run bitwise in ``chain.npy`` and ``bchain.npy``.
The kernels' own device counters see every launch the graphs replay.
The captures run with the cyclic garbage collector off.

Bitwise, because every random draw comes from the generator re-seeded
per sweep (the graphs replay the eager draws) and no atomic add of the
sweep hits one real slot twice: the scatter-adds into ``x`` and ``phi``
meet one index per real slot (repeats land only on the dropped pad
slot).  Needs no JAX: ``python -m pytest --noconftest -m cuda
tests/test_torch_graphs.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_cases import small_psrs

C, WARM, ADAPT = 4, 3, 120


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode "
                    "(the eager sweep they replay is tested on the CPU)")
    from pulsar_timing_gibbsspec_torch import build_crn_spectrum

    return build_crn_spectrum(small_psrs(), 4, 4, device="cuda")


def _gibbs(cm, **kw):
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs

    return PTABlockGibbs(cm, nchains=C, device="cuda", seed=4,
                         warmup_sweeps=WARM, white_adapt_iters=ADAPT,
                         chunk_size=8, **kw)


def _x0(g):
    return g.initial_sample(torch.Generator("cuda").manual_seed(5))


@pytest.mark.cuda
def test_graph_replay_equals_the_eager_sweep(tmp_path):
    cm = _card()
    g = _gibbs(cm, graphs=False)
    g.sample(_x0(g), outdir=tmp_path, niter=WARM + 2)
    drv = g.driver
    x = torch.as_tensor(drv.x_cur, device="cuda")
    b = drv.b.to("cuda")
    out = {}
    for graphs in (False, True):
        drv.graphs = graphs
        drv.b_mh_accepts.zero_()
        drv.begin_steady(x.clone(), b.clone())
        drv.steady_chunk(5, 17)
        out[graphs] = (drv.carry.x.clone(), drv.carry.b.clone(),
                       drv.b_mh_accepts.clone())
    for e, r, what in zip(out[False], out[True], ("x", "b", "accepts")):
        assert torch.equal(e, r), what
    assert drv.carry.graphed and set(drv.carry.graphs) == {
        "white", "red", "rho", "scale", "b_mh", "b_refresh"}
    assert torch.isfinite(out[True][1]).all()


@pytest.mark.cuda
def test_single_pulsar_graph_replay_equals_the_eager_sweep(tmp_path):
    """The single-pulsar path (``PulsarBlockGibbs`` on a NANOGrav-flagged
    pulsar: basis ECORR, the inverse-CDF rho draw, Bmax = 125, so both
    wide kernel forms): 17 steady sweeps replayed from the white, ecorr,
    rho, scale, b_mh and b_refresh graphs equal the eager sweeps
    bitwise."""
    from pulsar_timing_gibbsspec_torch import PulsarBlockGibbs, model_general
    from pulsar_timing_gibbsspec_torch.ops import kernels
    from test_torch_cases import nanograv_psr

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode "
                    "(the eager sweep they replay is tested on the CPU)")
    cm = model_general([nanograv_psr()], red_var=False, white_vary=True,
                       common_psd="spectrum", common_components=4,
                       device="cuda")
    assert cm.Bmax > kernels.CHOL_MAX_N
    g = PulsarBlockGibbs(cm, nchains=C, device="cuda", seed=4,
                         warmup_sweeps=WARM, white_adapt_iters=ADAPT,
                         chunk_size=8, graphs=False)
    g.sample(_x0(g), outdir=tmp_path, niter=WARM + 2)
    drv = g.driver
    x = torch.as_tensor(drv.x_cur, device="cuda")
    b = drv.b.to("cuda")
    out = {}
    for graphs in (False, True):
        drv.graphs = graphs
        drv.b_mh_accepts.zero_()
        drv.begin_steady(x.clone(), b.clone())
        drv.steady_chunk(5, 17)
        out[graphs] = (drv.carry.x.clone(), drv.carry.b.clone(),
                       drv.b_mh_accepts.clone())
    for e, r, what in zip(out[False], out[True], ("x", "b", "accepts")):
        assert torch.equal(e, r), what
    assert drv.carry.graphed and set(drv.carry.graphs) == {
        "white", "ecorr", "rho", "scale", "b_mh", "b_refresh"}
    assert torch.isfinite(out[True][1]).all()
    replayed = drv.carry.replayed_launches()
    for key in (("chol_solve_sample", "f32_wide"),
                ("gram_accumulate", "f32_wide"),
                ("gram_accumulate", "f32_dot_f64_reduce_wide")):
        assert replayed.get(key, 0) > 0, key


@pytest.mark.cuda
def test_resume_through_the_graphs_is_bitwise(tmp_path):
    cm = _card()
    niter, split = WARM + 1 + 32, WARM + 1 + 16
    full = _gibbs(cm)
    assert full.driver.graphs
    full.sample(_x0(full), outdir=tmp_path / "full", niter=niter)
    first = _gibbs(cm)
    first.sample(_x0(first), outdir=tmp_path / "split", niter=split)
    second = _gibbs(cm)
    second.sample(_x0(second), outdir=tmp_path / "split", niter=niter,
                  resume=True)
    for nm in ("chain.npy", "bchain.npy"):
        a = np.load(tmp_path / "full" / nm)
        assert np.isfinite(a).all()
        assert np.array_equal(a, np.load(tmp_path / "split" / nm)), nm


@pytest.mark.cuda
def test_the_card_counts_every_replayed_launch(tmp_path):
    """After the captures, the kernels' device counters grow by each
    capture's launches times its replays, for the b_mh and the refresh
    graphs alike (iteration 16 of steady sweeps 4 .. 20 is a refresh)."""
    from pulsar_timing_gibbsspec_torch.ops import kernels

    cm = _card()
    g = _gibbs(cm)
    kernels.reset_launches()
    g.sample(_x0(g), outdir=tmp_path, niter=WARM + 1 + 17)
    graphs = g.driver.carry
    dev = kernels.device_launches()
    replayed = graphs.replayed_launches()
    for key in (("chol_solve_sample", "f32"), ("gram_accumulate", "f32"),
                ("gram_accumulate", "f32_dot_f64_reduce")):
        assert replayed.get(key, 0) > 0, key
    for key, n in replayed.items():
        assert dev[key] - graphs.device_at_capture[key] == n, key


@pytest.mark.cuda
def test_the_captures_hold_the_collector_off(tmp_path, monkeypatch):
    """A graphed driver and its carry refer to each other, so an
    unreachable sampler's graphs are destroyed by the cyclic collector,
    whenever it runs; one destroyed while another graph is being
    captured invalidates that capture.  The collector runs before the
    captures and is off during each of them."""
    import gc

    from pulsar_timing_gibbsspec_torch.sampler import graphs

    seen = []
    real = torch.cuda.graph

    def graph(*args, **kwargs):
        seen.append(gc.isenabled())
        return real(*args, **kwargs)

    monkeypatch.setattr(graphs.torch.cuda, "graph", graph)
    cm = _card()
    g = _gibbs(cm)
    g.sample(_x0(g), outdir=tmp_path, niter=WARM + 2)
    assert g.driver.carry.graphed
    assert seen and not any(seen)
    assert gc.isenabled()
