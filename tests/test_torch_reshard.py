"""The port's elastic resume: ``tests/test_chaos.py``'s reshard cases,
``tests/test_runtime.py``'s device-count fault and layout reader and
``tests/test_lineage.py``'s layout refusal, on gloo ranks of this host's
CPU (at most 4 ranks per spawn; ``synth_pta``'s model padded to 4, 4
chains).

A checkpoint written under one mesh resumes through
``integrity.reshard_restore`` under 1, 2 and 4 ranks, 4 -> 2 -> 4, and
on the 2-d mesh (2, 2) -> (1, 1) -> (2, 1) -> (2, 2), and every resumed
chain is bitwise the uninterrupted run's; the
``device_count_change_on_resume`` fault overrides the asked device
count; a kill between the two replaces of a save on the (2, 2) mesh
rolls back on the writer and every rank retries in lock step under
``run_supervised``, bitwise.  The layout functions and refusals are held
against the JAX package's on the same inputs (a port checkpoint read by
the JAX ``read_layout``; the JAX ``reshard_restore`` refusing the same
directory with the same words).  Under a mesh, the models this slice
does not shard raise ``NotImplementedError`` naming ROADMAP A.14b.
"""

import shutil
import types

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from pulsar_timing_gibbsspec_torch.parallel import sharding
from pulsar_timing_gibbsspec_torch.runtime import faults, integrity

torch.set_num_threads(2)
KW = {k: v for k, v in R.SYNTH_KW.items() if k != "nchains"}


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """Every resume of the module, in dependency order: a world of 4
    writes the sources (and resumes 4 -> 4, and runs the 2-d kill); this
    process resumes under 1 and takes the 2-d (1, 1) step; a world of 2
    resumes under 2, takes 4 -> 2, the device-count fault and the 2-d
    (2, 1) step; a world of 4 takes 2 -> 4 and the 2-d (2, 2) step.  The
    uninterrupted runs are this process's."""
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs

    root = tmp_path_factory.mktemp("elastic")
    cm = R.synth_cm()
    x0 = R.x0_of(cm, 4)
    out = {"base16": PTABlockGibbs(cm, **R.SYNTH_KW).sample(
               x0, outdir=root / "base16", niter=16, save_every=4),
           "base24": PTABlockGibbs(cm, **R.SYNTH_KW).sample(
               x0, outdir=root / "base24", niter=24, save_every=4)}
    out["w4"] = sharding.spawn(R.write_sources, 4, args=(str(root),))[0]
    for src, dst in (("src4", "dev1"), ("src2d", "trip")):
        shutil.copytree(root / src, root / dst)
    g = integrity.reshard_restore(root / "dev1", cm, devices=1, **KW)
    out["dev1"] = (g.mesh, g.sample(x0, outdir=root / "dev1", niter=16,
                                    resume=True, save_every=4))
    g = integrity.reshard_restore(root / "trip", cm, devices=(1, 1), **KW)
    out["trip11"] = (g.mesh, g.sample(x0, outdir=root / "trip", niter=12,
                                      resume=True, save_every=4))
    out["w2"] = sharding.spawn(R.resume_steps, 2, args=(str(root), [
        ("src4", "dev2", 2, 16, None),
        ("src4", "updown", 2, 12, None),
        ("src4", "pool", 4, 16, 2),
        (None, "trip", (2, 1), 16, None)]))[0]
    out["w4b"] = sharding.spawn(R.resume_steps, 4, args=(str(root), [
        (None, "updown", 4, 16, None),
        (None, "trip", (2, 2), 24, None)]))[0]
    out["root"], out["cm"], out["x0"] = root, cm, x0
    return out


def test_reshard_resume_crn_bitwise(elastic):
    """A checkpoint written under 4 ranks resumes under 1, 2 and 4, each
    bitwise the uninterrupted run; the layout keeps the padded width and
    the shard map records the resuming mesh (none under 1)."""
    base = elastic["base16"]
    mesh1, chain1 = elastic["dev1"]
    assert mesh1 is None and np.array_equal(chain1, base)
    assert np.array_equal(elastic["w2"][0]["chain"], base)
    assert np.array_equal(elastic["w4"]["dev4"], base)
    root = elastic["root"]
    for name, dev in (("dev1", None), ("dev2", 2), ("dev4", 4)):
        info = integrity.read_layout(root / name)
        assert info["layout"]["pad_pulsars"] == 4
        if dev is None:
            assert info["shard_map"] is None
        else:
            assert info["shard_map"]["devices"] == dev


def test_reshard_down_and_back_up(elastic):
    """4 -> 2 -> 4: scale down mid-run, then back up, still bitwise."""
    assert elastic["w2"][1]["mesh"] == 2
    assert elastic["w4b"][0]["mesh"] == 4
    assert np.array_equal(elastic["w4b"][0]["chain"], elastic["base16"])
    assert integrity.read_layout(
        elastic["root"] / "updown")["shard_map"]["devices"] == 4


def test_device_count_change_fault_overrides_reshard(elastic):
    """Asked for 4 devices with the fault armed for 2, reshard_restore
    builds the 2-rank mesh, and the resume is bitwise."""
    step = elastic["w2"][2]
    assert step["mesh"] == 2
    assert step["layout"]["shard_map"]["devices"] == 2
    assert np.array_equal(step["chain"], elastic["base16"])


def test_reshard_roundtrip_2d_bitwise(elastic):
    """(2, 2) -> (1, 1) -> (2, 1) -> (2, 2): the final chain is bitwise
    the uninterrupted run's, per logical chain."""
    mesh11, _ = elastic["trip11"]
    assert mesh11 is None
    assert elastic["w2"][3]["mesh"] == 2
    last = elastic["w4b"][1]
    assert np.array_equal(last["chain"], elastic["base24"])
    info = last["layout"]
    assert info["layout"]["nchains"] == 4
    assert info["shard_map"]["axes"] == [["chain", 2], ["pulsar", 2]]


def test_chaos_kill_mid_run_2d_recovers_bitwise(elastic):
    """The torn-checkpoint kill on the (2, 2) mesh: the writer's crash
    between the two replaces reaches every rank at the same seam, the
    writer rolls back to .bak, and one supervised retry replays every
    chain bitwise."""
    w4 = elastic["w4"]
    assert np.array_equal(w4["kill"], elastic["base24"])
    assert w4["retries"] == 1 and w4["failures"] == ["crash"]
    assert w4["rollbacks"] == 1


@pytest.fixture(scope="module")
def jax_synth(synth_pta):
    return synth_pta


@pytest.mark.parametrize("devices,words", [
    (3, "padded pulsar"), ((3, 2), "chain count"), ((2, 3), "pulsar-axis")])
def test_reshard_refusals_match_jax(elastic, jax_synth, tmp_path, devices,
                                    words):
    """The indivisible counts raise before any mesh is made, each naming
    its knob, with the JAX package's words on the same directory."""
    from pulsar_timing_gibbsspec_tpu.runtime import integrity as jint

    dst = tmp_path / "bad"
    shutil.copytree(elastic["root"] / "src2d", dst)
    with pytest.raises(integrity.CheckpointError, match=words) as port:
        integrity.reshard_restore(dst, elastic["cm"], devices=devices, **KW)
    with pytest.raises(jint.CheckpointError) as jax:
        jint.reshard_restore(dst, jax_synth, devices=devices)
    assert str(port.value) == str(jax.value)


def test_reshard_refuses_another_world_and_padding(elastic, tmp_path):
    """A mesh larger than the world, a one-device resume inside a world
    of two (each rank would write the directory), and a model padded to
    another width than the checkpoint's are refused."""
    for w in ("w2", "w4b"):
        msg = elastic[w][-1]["refusal"]
        assert msg is not None and "world of that size" in msg
    dst = tmp_path / "w"
    shutil.copytree(elastic["root"] / "src4", dst)
    with pytest.raises(integrity.CheckpointError, match="world of that"):
        integrity.reshard_restore(dst, elastic["cm"], devices=2, **KW)
    with pytest.raises(integrity.CheckpointError, match="pad_pulsars=4"):
        integrity.reshard_restore(dst, R.synth_cm(pad=2), devices=1, **KW)


def test_read_layout_matches_jax(elastic):
    """The JAX ``read_layout`` reads a port manifest written under a mesh
    and gets the port's ``layout`` / ``shard_map`` sections."""
    from pulsar_timing_gibbsspec_tpu.runtime import integrity as jint

    for name in ("src4", "src2d", "dev1"):
        d = elastic["root"] / name
        port, jax = integrity.read_layout(d), jint.read_layout(d)
        assert port == jax
        assert set(port) == {"layout", "shard_map"}
    lay = integrity.read_layout(elastic["root"] / "src2d")
    assert lay["shard_map"] == {"devices": 4, "axis": "pulsar",
                                "axes": [["chain", 2], ["pulsar", 2]],
                                "platform": "cpu"}
    assert lay["layout"]["pulsars"] == ["FAKE_CHAOS"]


def test_read_layout_roundtrip(tmp_path):
    np.save(tmp_path / "chain.npy", np.zeros((3, 2)))
    lay = {"facade": "PTABlockGibbs", "nchains": 2, "pad_pulsars": 8,
           "pulsars": ["A", "B"], "record_every": 1}
    shard = {"devices": 8, "axis": "pulsar", "platform": "cpu"}
    integrity.write_manifest(tmp_path, rows=3,
                             extra={"layout": lay, "shard_map": shard})
    assert integrity.read_layout(tmp_path) == {"layout": lay,
                                               "shard_map": shard}
    integrity.write_manifest(tmp_path, rows=3)
    assert integrity.read_layout(tmp_path) is None


def test_device_count_override_matches_jax():
    """One firing is consumed, then the default comes back, as in the
    JAX package."""
    from pulsar_timing_gibbsspec_tpu.runtime import faults as jfaults

    try:
        for mod in (faults, jfaults):
            mod.inject("device_count_change_on_resume", devices=4)
        got = [(m.device_count_override(8), m.device_count_override(8))
               for m in (faults, jfaults)]
        assert got[0] == got[1] == (4, 8)
        assert faults.device_count_override((2, 2)) == (2, 2)
    finally:
        jfaults.clear()


def test_device_loss_fault_and_class():
    from pulsar_timing_gibbsspec_torch.runtime.supervisor import (
        classify_failure)

    faults.inject("device_loss", point="sample.loop", at_row=3, devices=2)
    faults.fire("sample.loop", row=2)
    with pytest.raises(faults.DeviceLost, match="2 device") as ei:
        faults.fire("sample.loop", row=3)
    assert ei.value.devices == 2 and ei.value.slice_id is None
    assert classify_failure(ei.value) == "device_loss"
    import pickle

    back = pickle.loads(pickle.dumps(ei.value))
    assert (type(back), back.devices, str(back)) == (
        faults.DeviceLost, 2, str(ei.value))


@pytest.mark.parametrize("got", [["A", "X", "C"], ["A"], ["A", "B", "C"],
                                 []])
def test_layout_mismatch_matches_jax(tmp_path, got):
    """The first mismatched pulsar, by index and by name, as the JAX
    package names it (a strict prefix refuses at the boundary; equal
    layouts and layout-less checkpoints pass)."""
    from pulsar_timing_gibbsspec_tpu.runtime import integrity as jint

    want = ["A", "B", "C"] if got != [] else []
    errs = []
    for mod in (integrity, jint):
        try:
            mod.check_layout_pulsars(tmp_path, want, got)
            errs.append(None)
        except mod.LayoutMismatch as exc:
            errs.append((exc.index, exc.expected, exc.got, str(exc)))
    assert errs[0] == errs[1]
    if got == ["A", "X", "C"]:
        assert errs[0][:3] == (1, "B", "X")
    if got == ["A"]:
        assert errs[0][:3] == (1, "B", "<none>")


def test_load_resume_refuses_layout_disagreement(elastic):
    d = elastic["root"] / "dev1"
    with pytest.raises(integrity.LayoutMismatch) as ei:
        integrity.load_resume(d, pta=types.SimpleNamespace(pulsars=["X"]))
    assert (ei.value.index, ei.value.expected, ei.value.got) == (
        0, "FAKE_CHAOS", "X")
    got = integrity.load_resume(d, pta=elastic["cm"])
    assert got is not None and got[2] == 16


def _duck_mesh(shape):
    return types.SimpleNamespace(
        devices=np.arange(int(np.prod(shape))).reshape(shape),
        axis_names=("chain", "pulsar")[-len(shape):],
        size=int(np.prod(shape)), rank=0, device=torch.device("cpu"),
        chain_index=0, pulsar_index=0)


def test_unsharded_models_refused_under_a_mesh():
    """HD (its Schur stage), the ensemble stage and the powerlaw hyper
    block raise NotImplementedError naming ROADMAP A.14b under a mesh."""
    from test_torch_cases import small_psrs

    from pulsar_timing_gibbsspec_torch import (PTABlockGibbs,
                                               build_crn_spectrum,
                                               model_general)

    psrs = small_psrs()
    hd = model_general(psrs, tm_svd=True, white_vary=True,
                       common_psd="spectrum", common_components=3,
                       red_psd="spectrum", red_components=3, orf="hd",
                       device="cpu")
    crn = build_crn_spectrum(psrs, 3, 3, device="cpu")
    pl = model_general(psrs, tm_svd=True, white_vary=True,
                       common_psd="spectrum", common_components=3,
                       red_psd="powerlaw", red_components=3, device="cpu")
    for cm, kw, what in ((hd, {}, "correlated ORF"),
                         (crn, {"ensemble": True}, "ensemble"),
                         (pl, {}, "powerlaw hyper")):
        with pytest.raises(NotImplementedError, match="A.14b") as ei:
            PTABlockGibbs(cm, nchains=2, device="cpu",
                          mesh=_duck_mesh((1,)), **kw)
        assert what in str(ei.value)
    with pytest.raises(ValueError, match="torch-backend option"):
        PTABlockGibbs(crn, device="cpu", backend="numpy",
                      mesh=_duck_mesh((1,)))
