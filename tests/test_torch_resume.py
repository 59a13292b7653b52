"""Checkpoints and bitwise resume of the port, on the CPU.

A run split as ``sample(niter=N1)`` then ``sample(niter=N,
resume=True)`` in a fresh sampler equals the uninterrupted run bitwise,
in ``chain.npy`` and ``bchain.npy``, at ``record_every`` 1 and 2 (the
split on a chunk boundary of the grid anchored at the first steady
sweep).  A chain-count or thinning mismatch raises, as does a resume
on another device type than the checkpoint's streams; a corrupted
``chain.npy`` rolls back to the ``.bak`` generation (and the resumed run
is still bitwise), with both generations corrupt ``CheckpointError`` is
raised.  The JAX package's ``integrity.verify`` accepts a port
checkpoint, its ``ChainStore.load_resume`` reads the same rows and
iteration, and its ``write_manifest`` writes the port's manifest byte
for byte (the time stamp aside).  Each steady sweep is a pure function
of its state and its iteration index.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_cases import small_psrs

torch.set_num_threads(2)

C, WARM, ADAPT, CHUNK = 3, 3, 120, 8
#: the uninterrupted run, and the split: iteration 20 is the end of the
#: second steady chunk (the steady grid starts at WARM + 1 = 4)
NITER, SPLIT = 30, 20


@pytest.fixture(scope="module")
def cm():
    from pulsar_timing_gibbsspec_torch import build_crn_spectrum

    return build_crn_spectrum(small_psrs(), 4, 4, device="cpu")


def _gibbs(cm, record_every=1, nchains=C):
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs

    return PTABlockGibbs(cm, nchains=nchains, device="cpu", seed=11,
                         warmup_sweeps=WARM, white_adapt_iters=ADAPT,
                         chunk_size=CHUNK, record_every=record_every)


def _x0(g):
    return g.initial_sample(torch.Generator().manual_seed(2))


@pytest.fixture(scope="module")
def full(cm, tmp_path_factory):
    """The uninterrupted runs at record_every 1 and 2."""
    out = {}
    for k in (1, 2):
        g = _gibbs(cm, k)
        d = tmp_path_factory.mktemp(f"full{k}")
        g.sample(_x0(g), outdir=d, niter=NITER, save_every=CHUNK)
        out[k] = (g, d)
    return out


@pytest.mark.parametrize("record_every", [1, 2])
def test_resume_is_bitwise(cm, full, tmp_path, record_every):
    g, d = full[record_every]
    first = _gibbs(cm, record_every)
    first.sample(_x0(first), outdir=tmp_path, niter=SPLIT,
                 save_every=CHUNK)
    second = _gibbs(cm, record_every)
    chain = second.sample(_x0(second), outdir=tmp_path, niter=NITER,
                          resume=True, save_every=CHUNK)
    assert chain.shape == g.chain.shape
    for nm in ("chain.npy", "bchain.npy"):
        assert np.array_equal(np.load(tmp_path / nm), np.load(d / nm)), nm
    assert np.array_equal(chain, g.chain)
    assert np.array_equal(second.bchain, g.bchain)
    assert np.isfinite(chain).all()


def test_checkpoint_files(full):
    g, d = full[1]
    names = {p.name for p in d.iterdir()}
    assert {"chain.npy", "bchain.npy", "adapt.npz", "manifest.json",
            "pars_chain.txt", "pars_bchain.txt", "metrics.jsonl",
            "chain.npy.bak", "manifest.bak.json"} <= names
    man = json.loads((d / "manifest.json").read_text())
    assert man["rows"] == NITER
    assert man["layout"]["backend"] == "torch"
    assert man["layout"]["nchains"] == C
    assert man["layout"]["pulsars"] == list(g.cm.pulsars)
    assert "splitmix64" in man["layout"]["rng"]
    assert (d / "pars_bchain.txt").read_text().split() == g.b_param_names
    with np.load(d / "adapt.npz") as z:
        assert int(z["iter"]) == NITER and int(z["it_cur"]) == NITER
        assert int(z["nchains"]) == C and int(z["seed"]) == 11
        for key in ("x_cur", "b_pad", "chol_white", "mode_white",
                    "asqrt_white", "aclength_white", "b_mh_accepts"):
            assert key in z.files, key


def test_resume_mismatches_raise(cm, full, tmp_path):
    import shutil

    g, d = full[1]
    shutil.copytree(d, tmp_path / "c")
    other = _gibbs(cm, 1, nchains=2)
    with pytest.raises(RuntimeError, match="nchains"):
        other.sample(_x0(other), outdir=tmp_path / "c", niter=NITER + 8,
                     resume=True)
    state = dict(np.load(d / "adapt.npz"))
    with pytest.raises(RuntimeError, match="nchains=3"):
        other.driver.load_adapt_state(state)
    thin = _gibbs(cm, 2)
    with pytest.raises(RuntimeError, match="record_every=1"):
        thin.sample(_x0(thin), outdir=tmp_path / "c", niter=NITER + 8,
                    resume=True)
    state.pop("chol_white")
    with pytest.raises(RuntimeError, match="white-noise adaptation"):
        _gibbs(cm).driver.load_adapt_state(state)


@pytest.mark.parametrize("saved", ["cuda", "cpu"])
def test_resume_checks_the_stream_device(cm, full, tmp_path, saved):
    """The checkpoint's layout names the device type of the sampling
    generator; a resume on another device type is refused (its streams
    differ), one on the same device type continues."""
    import shutil

    _, d = full[1]
    out = tmp_path / "c"
    shutil.copytree(d, out)
    man = json.loads((out / "manifest.json").read_text())
    assert man["layout"]["rng_device"] == "cpu"
    man["layout"]["rng_device"] = saved
    (out / "manifest.json").write_text(json.dumps(man))
    g = _gibbs(cm)
    if saved == "cpu":
        chain = g.sample(_x0(g), outdir=out, niter=NITER + 2, resume=True,
                         save_every=CHUNK)
        assert np.isfinite(chain).all() and len(chain) == NITER + 2
    else:
        with pytest.raises(ValueError, match="cuda.*cpu"):
            g.sample(_x0(g), outdir=out, niter=NITER + 2, resume=True)


@pytest.mark.parametrize("key", ["it_cur", "x_cur"])
def test_checkpoint_without_its_carry_raises(cm, full, key):
    _, d = full[1]
    state = dict(np.load(d / "adapt.npz"))
    state.pop(key)
    with pytest.raises(RuntimeError, match=key):
        _gibbs(cm).driver.load_adapt_state(state)


def test_resume_rows_must_match_the_iteration(cm, full):
    """Chain rows from another save than adapt.npz's iteration raise
    instead of leaving rows unwritten."""
    _, d = full[1]
    drv = _gibbs(cm).driver
    drv.load_adapt_state(dict(np.load(d / "adapt.npz")))
    cs, bs = drv.chain_shapes(NITER + 8)
    with pytest.raises(RuntimeError, match="different saves"):
        next(drv.run(drv.x_cur, np.zeros(cs), np.zeros(bs), NITER - 1,
                     NITER + 8))


def test_backup_holds_the_previous_set(full):
    """After the last save the .bak generation verifies, holds fewer rows
    than the primaries and shares no file with them (the rotation links
    the previous set; each save replaces every primary)."""
    import os

    from pulsar_timing_gibbsspec_torch.runtime import integrity

    _, d = full[1]
    bman = integrity.read_manifest(d, integrity.MANIFEST_BAK)
    assert integrity.verify(d, bman, suffix=".bak")["ok"]
    assert bman["rows"] < integrity.read_manifest(d)["rows"] == NITER
    for nm in ("chain.npy", "bchain.npy", "adapt.npz", "manifest.json"):
        bak = ("manifest.bak.json" if nm == "manifest.json"
               else nm + ".bak")
        assert not os.path.samefile(d / nm, d / bak), nm


def _corrupt(path):
    raw = bytearray(path.read_bytes())
    raw[-3] ^= 0xFF
    path.write_bytes(bytes(raw))


def test_corrupt_checkpoint_rolls_back(cm, full, tmp_path):
    from pulsar_timing_gibbsspec_torch.runtime.integrity import (
        CheckpointError)

    g, _ = full[1]
    first = _gibbs(cm)
    first.sample(_x0(first), outdir=tmp_path, niter=SPLIT,
                 save_every=CHUNK)
    _corrupt(tmp_path / "chain.npy")
    second = _gibbs(cm)
    with pytest.warns(RuntimeWarning, match="rolled back"):
        chain = second.sample(_x0(second), outdir=tmp_path, niter=NITER,
                              resume=True, save_every=CHUNK)
    assert np.array_equal(chain, g.chain)
    assert np.array_equal(second.bchain, g.bchain)
    _corrupt(tmp_path / "chain.npy")
    _corrupt(tmp_path / "chain.npy.bak")
    with pytest.raises(CheckpointError, match="no verified .bak"):
        _gibbs(cm).sample(_x0(g), outdir=tmp_path, niter=NITER,
                          resume=True)


def test_an_interrupted_run_keeps_every_row_and_resumes(cm, full,
                                                        tmp_path):
    """An exception between checkpoints (here after the rows up to 28
    are written, the last save at 20) leaves a verified checkpoint of
    every written row: the save on its thread ends, the bounded-loss
    flush follows. Resuming from it finishes the run bitwise."""
    from pulsar_timing_gibbsspec_torch.runtime import integrity

    g, _ = full[1]
    first = _gibbs(cm)
    run = first.driver.run

    def interrupted(*args):
        for upto in run(*args):
            yield upto
            if upto >= 28:
                raise KeyboardInterrupt

    first.driver.run = interrupted
    with pytest.raises(KeyboardInterrupt):
        first.sample(_x0(first), outdir=tmp_path, niter=NITER,
                     save_every=2 * CHUNK)
    rep = integrity.verify(tmp_path)
    assert rep["ok"] and rep["rows"] == 28
    assert np.array_equal(np.load(tmp_path / "chain.npy"), g.chain[:28])
    second = _gibbs(cm)
    chain = second.sample(_x0(second), outdir=tmp_path, niter=NITER,
                          resume=True, save_every=2 * CHUNK)
    assert np.array_equal(chain, g.chain)
    assert np.array_equal(second.bchain, g.bchain)


def test_jax_package_reads_a_port_checkpoint(full):
    from pulsar_timing_gibbsspec_torch.sampler.chains import ChainStore
    from pulsar_timing_gibbsspec_tpu.runtime import integrity as jint
    from pulsar_timing_gibbsspec_tpu.sampler.chains import \
        ChainStore as JaxStore

    g, d = full[2]
    assert jint.verify(d)["ok"]
    assert jint.verify(d, jint.read_manifest(d, jint.MANIFEST_BAK),
                       suffix=".bak")["ok"]
    ours = ChainStore(d, g.param_names, g.b_param_names).load_resume()
    theirs = JaxStore(d, g.param_names, g.b_param_names).load_resume()
    assert ours[2] == theirs[2] == g.chain.shape[0]
    assert np.array_equal(ours[0], theirs[0])
    assert np.array_equal(ours[1], theirs[1])
    assert int(theirs[3]["it_cur"]) == NITER
    # the manifest format, byte for byte
    ours_txt = (d / "manifest.json").read_text()
    man = json.loads(ours_txt)
    jint.write_manifest(d, man["rows"], extra={
        k: man[k] for k in ("layout", "shard_map")})
    theirs_txt = (d / "manifest.json").read_text()
    stamp = json.loads(theirs_txt)["written_at"]
    assert theirs_txt == ours_txt.replace(
        json.dumps(man["written_at"]), json.dumps(stamp))


@pytest.fixture(scope="module")
def adapted(cm, tmp_path_factory):
    g = _gibbs(cm)
    g.sample(_x0(g), outdir=tmp_path_factory.mktemp("adapted"),
             niter=WARM + 2)
    drv = g.driver
    return drv, torch.as_tensor(drv.x_cur), drv.b.clone()


@pytest.mark.parametrize("t", [5, 9, 16, 23])
def test_steady_sweep_is_pure_in_its_index(adapted, t):
    """Sweep ``t`` re-run from the state before it gives the same state
    after it, whatever ran on the generator in between; sweep ``t + 1``
    from that state gives another.  Sweep 16 is a refresh."""
    drv, x, b = adapted

    def sweep(t):
        drv.begin_steady(x.clone(), b.clone())
        drv.steady_chunk(t, 1)
        return drv.carry.x, drv.carry.b

    x1, b1 = sweep(t)
    sweep(t + 1)
    x2, b2 = sweep(t)
    assert torch.equal(x1, x2) and torch.equal(b1, b2)
    x3, b3 = sweep(t + 1)
    assert not torch.equal(x1, x3)
