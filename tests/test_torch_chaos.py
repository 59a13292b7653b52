"""The port's chaos suite: ``tests/test_chaos.py``'s cases on the port.

Every injected fault (a NaN'd row, the device error, a kill between the
two ``os.replace`` calls of a save, a truncated ``chain.npy``, a
corrupted ``adapt.npz``, a drain request, a stalled wait) is detected,
recovered by rollback or retry, and the supervised run's final chain is
bitwise the port's own uninterrupted run (on the CPU, the small CRN
model of ``test_torch_resume.py``).  Under three shared schedules the
port's ``SupervisorReport`` (status, attempts, retries, failure classes,
refolds, backoff delays) and the kinds and rows of the events in
``metrics.jsonl`` are the JAX package's under its ``numpy`` backend, as
``test_chaos.py`` runs it; at one sweep per chunk the port yields every
row, as that backend does.  Two hazards of the port's own: a stalled
watchdog worker that wakes while the retry runs, and a retry on the same
sampler object, which must equal a fresh object's resume.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from test_torch_cases import small_psrs

from pulsar_timing_gibbsspec_torch.runtime import (faults, integrity,
                                                   preemption, run_supervised,
                                                   telemetry)

torch.set_num_threads(2)

NITER, SAVE = 60, 20
#: sampler options: one sweep per chunk (every row a chunk boundary, as
#: the JAX numpy backend yields every row)
KW = dict(device="cpu", seed=1, warmup_sweeps=3, white_adapt_iters=120,
          chunk_size=1, progress=False)


def _nosleep(s):
    pass


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    telemetry.reset()
    preemption.reset()
    yield
    faults.clear()
    preemption.reset()


@pytest.fixture(scope="module")
def cm():
    from pulsar_timing_gibbsspec_torch import build_crn_spectrum

    return build_crn_spectrum(small_psrs(), 4, 4, device="cpu")


def _gibbs(cm, **kw):
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs

    return PTABlockGibbs(cm, nchains=kw.pop("nchains", 1), **{**KW, **kw})


@pytest.fixture(scope="module")
def x0(cm):
    return _gibbs(cm).initial_sample(torch.Generator().manual_seed(0))[0]


@pytest.fixture(scope="module")
def baseline(cm, x0, tmp_path_factory):
    """The uninterrupted run: the bitwise recovery target."""
    return _gibbs(cm).sample(x0, outdir=tmp_path_factory.mktemp("base"),
                             niter=NITER, save_every=SAVE)


def _events(outdir):
    with open(outdir / "metrics.jsonl") as fh:
        return [json.loads(ln) for ln in fh]


def test_kill_between_replaces_recovers_bitwise(cm, x0, baseline, tmp_path):
    """A crash in the torn window of the save at row 40 (chain.npy
    replaced, bchain.npy not): the retry finds the manifest mismatch,
    rolls back to .bak and replays bitwise."""
    faults.inject("crash", point="chainstore.between_replaces", at_row=40)
    chain, rep = run_supervised(_gibbs(cm), x0, tmp_path, NITER,
                                save_every=SAVE, sleep=_nosleep)
    assert np.array_equal(chain, baseline)
    assert rep.retries == 1 and rep.failures[0]["kind"] == "crash"
    assert telemetry.get("rollbacks") == 1
    assert telemetry.get("corrupt_checkpoints") == 1
    evs = [e.get("event") for e in _events(tmp_path)]
    assert "checkpoint_corrupt" in evs and "checkpoint_rollback" in evs


@pytest.mark.parametrize("damage", ["truncate_chain", "corrupt_adapt"])
def test_damaged_checkpoint_rolls_back_and_extends_bitwise(cm, x0, tmp_path,
                                                           damage):
    """A completed run's chain.npy truncated (adapt.npz corrupted), then
    extended under supervision: verification fails, the .bak restores the
    previous checkpoint, and the extension equals one never damaged."""
    _gibbs(cm).sample(x0, outdir=tmp_path / "run", niter=NITER,
                      save_every=SAVE)
    shutil.copytree(tmp_path / "run", tmp_path / "ref")
    if damage == "truncate_chain":
        with open(tmp_path / "run" / "chain.npy", "r+b") as fh:
            fh.truncate(fh.seek(0, 2) // 2)
    else:
        with open(tmp_path / "run" / "adapt.npz", "r+b") as fh:
            fh.seek(fh.seek(0, 2) // 2)
            fh.write(b"\xde\xad\xbe\xef")
    chain, _ = run_supervised(_gibbs(cm), x0, tmp_path / "run", 80,
                              save_every=SAVE, sleep=_nosleep)
    ref, _ = run_supervised(_gibbs(cm), x0, tmp_path / "ref", 80,
                            save_every=SAVE, sleep=_nosleep)
    assert np.array_equal(chain, ref)
    assert telemetry.get("rollbacks") == 1
    assert telemetry.get("corrupt_checkpoints") == 1


def test_corruption_without_backup_raises(cm, x0, tmp_path):
    """No verified .bak to fall back to: the supervisor gives up loudly
    (CheckpointError), neither looping nor resuming from garbage."""
    from pulsar_timing_gibbsspec_torch.runtime import CheckpointError

    _gibbs(cm).sample(x0, outdir=tmp_path, niter=20, save_every=30)
    for nm in tmp_path.glob("*.bak*"):
        nm.unlink()
    with open(tmp_path / "chain.npy", "r+b") as fh:
        fh.truncate(fh.seek(0, 2) // 2)
    with pytest.raises(CheckpointError, match="no verified .bak"):
        run_supervised(_gibbs(cm), x0, tmp_path, 40, save_every=SAVE,
                       sleep=_nosleep)


@pytest.mark.parametrize("chunk", [1, 4])
def test_nan_rows_rewind_and_recover_bitwise(cm, x0, baseline, tmp_path,
                                             chunk):
    """A NaN'd recorded row: the sentinel stops it before the checkpoint,
    the retry rewinds and replays clean (per sweep, and with four sweeps
    per chunk, where the row lands inside a chunk's writeback)."""
    if chunk != 1:
        baseline = _gibbs(cm, chunk_size=chunk).sample(
            x0, outdir=tmp_path / "base", niter=NITER, save_every=SAVE)
    faults.inject("nan_rows", at_row=45)
    chain, rep = run_supervised(_gibbs(cm, chunk_size=chunk), x0,
                                tmp_path / "chaos", NITER, save_every=SAVE,
                                sleep=_nosleep)
    assert np.array_equal(chain, baseline)
    assert rep.retries == 1 and rep.refolds == 0
    assert rep.failures[0]["kind"] == "divergence"
    assert telemetry.get("sentinel_trips") == 1
    divs = [e for e in _events(tmp_path / "chaos")
            if e.get("event") == "divergence"]
    assert divs and divs[0]["row"] == 45 and divs[0]["what"] == "nonfinite"


def test_repeated_divergence_refolds_the_seed(cm, x0, baseline, tmp_path):
    """The same divergence on the deterministic replay: the supervisor
    refolds the checkpoint's seed, so the re-draw takes another stream
    (and the chain past the checkpoint is, by design, not the
    baseline's)."""
    faults.inject("nan_rows", at_row=45, times=2)
    chain, rep = run_supervised(_gibbs(cm), x0, tmp_path, NITER,
                                save_every=SAVE, sleep=_nosleep)
    assert np.isfinite(chain).all()
    assert rep.retries == 2 and rep.refolds == 1
    assert telemetry.get("refolds") == 1
    assert np.array_equal(chain[:40], baseline[:40])
    assert not np.array_equal(chain[40:], baseline[40:])
    assert any(e.get("event") == "prng_refold" for e in _events(tmp_path))
    assert integrity.verify(tmp_path)["ok"]


def test_device_error_backoff_and_bitwise_recovery(cm, x0, baseline,
                                                   tmp_path):
    """Device-class failures retry under capped exponential backoff; the
    flush bounds the loss, so each retry resumes past the fault row."""
    faults.inject("xla_error", point="sample.loop", at_row=30, times=3)
    delays = []
    chain, rep = run_supervised(_gibbs(cm), x0, tmp_path, NITER,
                                save_every=SAVE, backoff_base=0.5,
                                backoff_cap=1.0, jitter=0.0,
                                sleep=delays.append)
    assert np.array_equal(chain, baseline)
    assert [f["kind"] for f in rep.failures] == ["device"] * 3
    assert delays == [0.5, 1.0, 1.0]
    retries = [e for e in _events(tmp_path)
               if e.get("event") == "supervised_retry"]
    assert [r["backoff_s"] for r in retries] == [0.5, 1.0, 1.0]


def test_final_flush_bounds_loss_on_interrupt(cm, x0, tmp_path):
    """A failure between checkpoints (row 30, the last save at 20) still
    persists every checked row: resume starts from row 30."""
    from pulsar_timing_gibbsspec_torch.sampler.chains import ChainStore

    faults.inject("xla_error", point="sample.loop", at_row=30)
    g = _gibbs(cm)
    with pytest.raises(faults.InjectedDeviceError):
        g.sample(x0, outdir=tmp_path, niter=NITER, save_every=SAVE)
    got = ChainStore(tmp_path, g.param_names,
                     g.b_param_names).load_resume()
    assert got is not None and got[2] == 30
    assert any(e.get("event") == "final_flush" for e in _events(tmp_path))


def test_supervisor_gives_up_after_max_retries(cm, x0, tmp_path):
    faults.inject("xla_error", point="sample.loop", at_row=10, times=99)
    with pytest.raises(faults.InjectedDeviceError):
        run_supervised(_gibbs(cm), x0, tmp_path, NITER, save_every=SAVE,
                       max_retries=2, sleep=_nosleep)
    evs = [e.get("event") for e in _events(tmp_path)]
    assert "supervised_giving_up" in evs
    assert evs.count("supervised_failure") == 3


def test_report_counters_match_telemetry(cm, x0, tmp_path):
    faults.inject("crash", point="chainstore.between_replaces", at_row=40)
    _, rep = run_supervised(_gibbs(cm), x0, tmp_path, NITER,
                            save_every=SAVE, sleep=_nosleep)
    assert rep.attempts == 2
    assert telemetry.get("retries") == rep.retries == 1
    d = rep.as_dict()
    assert d["backend"] == "torch" and len(d["failures"]) == 1


def test_sigterm_drains_to_verified_checkpoint_and_resumes_bitwise(
        cm, x0, baseline, tmp_path):
    """A drain request at row 30 stops the loop, flushes, verifies and
    returns the resumable ``preempted`` status; the next incarnation
    resumes bitwise."""
    faults.inject("sigterm_at_seam", point="sample.loop", at_row=30,
                  seconds=60.0)
    chain, rep = run_supervised(_gibbs(cm), x0, tmp_path, NITER,
                                save_every=SAVE, sleep=_nosleep)
    assert rep.status == "preempted"
    assert rep.attempts == 1 and rep.retries == 0 and not rep.failures
    assert telemetry.get("preempt_requests") == 1
    assert telemetry.get("preempt_drains") == 1
    assert telemetry.get_gauge("drain_latency_ms") is not None
    v = integrity.verify(tmp_path)
    assert v["ok"] and v["rows"] == 30
    assert np.array_equal(chain[:30], baseline[:30])
    evs = [e.get("event") for e in _events(tmp_path)]
    for want in ("drain_requested", "preempted_drain",
                 "supervised_preempted"):
        assert want in evs, want
    preemption.reset()
    chain2, rep2 = run_supervised(_gibbs(cm), x0, tmp_path, NITER,
                                  save_every=SAVE, sleep=_nosleep)
    assert rep2.status == "completed"
    assert np.array_equal(chain2, baseline)


@pytest.mark.parametrize("deadline_s", [60.0, 0.0])
def test_drain_in_the_driver_lands_or_drops_the_chunk_in_flight(
        cm, x0, baseline, deadline_s):
    """A drain requested while the driver has a chunk in flight (chunks
    of 4): it queues nothing more, then writes the chunk back, or drops
    it when landing it would blow the deadline (0 s); either way the
    checkpointable state describes the last chunk written back."""
    drv = _gibbs(cm, chunk_size=4).driver
    cs, bs = drv.chain_shapes(NITER)
    chain, bchain = np.zeros(cs), np.zeros(bs)
    run = drv.run(x0, chain, bchain, 0, NITER)
    assert next(run) == 4 and next(run) == 8       # chunk 8-12 in flight
    preemption.request_drain(deadline_s=deadline_s)
    rows = list(run)
    landed = deadline_s > 0
    assert rows == ([12] if landed else [])
    assert drv.it_cur == (12 if landed else 8)
    assert telemetry.get("drain_abandoned_chunks") == (0 if landed else 1)
    # the carry is the state entering iteration it_cur: the baseline's
    # row there, before the record's float32 rounding
    state = drv.adapt_state()
    assert int(state["it_cur"]) == drv.it_cur
    assert np.array_equal(state["x_cur"][0].astype(np.float32),
                          baseline[drv.it_cur].astype(np.float32))
    assert np.array_equal(chain[:drv.it_cur], baseline[:drv.it_cur])


def test_kill_during_drain_rolls_back_to_backup(cm, x0, baseline, tmp_path):
    """chain.npy damaged after the drain's flush: the drain verifies,
    rolls back to .bak and still reports a verified (earlier)
    checkpoint; the next incarnation extends bitwise."""
    faults.inject("sigterm_at_seam", point="sample.loop", at_row=30,
                  seconds=60.0)
    faults.inject("truncate_file", point="chainstore.post_save",
                  at_row=25, path="chain.npy")
    _, rep = run_supervised(_gibbs(cm), x0, tmp_path, NITER,
                            save_every=SAVE, sleep=_nosleep)
    assert rep.status == "preempted"
    assert telemetry.get("rollbacks") == 1
    v = integrity.verify(tmp_path)
    assert v["ok"] and v["rows"] == 20
    drains = [e for e in _events(tmp_path)
              if e.get("event") == "preempted_drain"]
    assert drains and drains[0]["verified"] and drains[0]["rolled_back"]
    preemption.reset()
    faults.clear()
    chain2, rep2 = run_supervised(_gibbs(cm), x0, tmp_path, NITER,
                                  save_every=SAVE, sleep=_nosleep)
    assert rep2.status == "completed"
    assert np.array_equal(chain2, baseline)


def test_stalled_worker_wakes_during_the_retry(cm, x0, tmp_path):
    """A stall at the ``dispatch.chunk`` seam past the watchdog's
    deadline: the wait is abandoned as the ``stall`` class and retried.
    The abandoned worker sleeps on and wakes while the retry samples
    (the retry waits for it after its first rows); it has nothing left
    to do on the device, and the retried chain is bitwise the unstalled
    run's."""
    from pulsar_timing_gibbsspec_torch.runtime import DispatchWatchdog

    kw = dict(chunk_size=4)
    base = _gibbs(cm, **kw).sample(x0, outdir=tmp_path / "base", niter=24,
                                   save_every=4)
    boxes = []

    def on_event(stage, info):
        if stage == "dump":          # before the worker is detached
            boxes.append(wd._inbox)

    wd = DispatchWatchdog(k=4.0, floor_s=0.2, first_floor_s=60.0,
                          poll_s=0.01, on_event=on_event)
    faults.inject("stall", point="dispatch.chunk", at_row=12, seconds=1.5)
    g = _gibbs(cm, watchdog=wd, **kw)
    run, attempts, woke = g.driver.run, [], []

    def watched(*args):
        attempts.append(1)
        for upto in run(*args):
            yield upto
            if len(attempts) == 2 and not woke:
                # the stalled worker ends its fn while this retry runs
                woke.append(boxes[0]["done"].wait(10.0))

    g.driver.run = watched
    chain, rep = run_supervised(g, x0, tmp_path / "chaos", 24,
                                save_every=4, sleep=_nosleep)
    assert woke == [True]
    assert np.array_equal(chain, base)
    assert np.array_equal(g.bchain, np.load(tmp_path / "base" /
                                            "bchain.npy"))
    assert rep.status == "completed"
    assert rep.stall_retries == 1 and rep.retries == 0
    assert rep.failures[0]["kind"] == "stall"
    assert telemetry.get("watchdog_stalls") == 1
    assert telemetry.get("watchdog_dumps") == 1
    assert telemetry.get("stall_retries") == 1


def test_stall_budget_is_capped(x0, tmp_path):
    """A stall that never clears exhausts its own budget and re-raises."""
    from pulsar_timing_gibbsspec_torch.runtime import DispatchStall

    class AlwaysStalls:
        backend_name = "torch"
        chain = None

        def sample(self, *a, **k):
            raise DispatchStall("wedged")

    with pytest.raises(DispatchStall):
        run_supervised(AlwaysStalls(), x0, tmp_path, NITER, save_every=SAVE,
                       stall_max_retries=2, sleep=_nosleep)
    evs = [e.get("event") for e in _events(tmp_path)]
    assert "supervised_giving_up" in evs
    assert telemetry.get("stall_retries") == 2


def test_sticky_device_error_ends_in_the_budget(x0, tmp_path):
    """A sticky CUDA error (it poisons the context, every attempt fails
    alike) is the ``device`` class and ends in the retry budget."""
    class Sticky:
        backend_name = "torch"
        chain = None
        calls = 0

        def sample(self, *a, **k):
            Sticky.calls += 1
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

    with pytest.raises(RuntimeError, match="illegal memory access"):
        run_supervised(Sticky(), x0, tmp_path, NITER, max_retries=3,
                       sleep=_nosleep)
    assert Sticky.calls == 4
    fails = [e for e in _events(tmp_path)
             if e.get("event") == "supervised_failure"]
    assert [f["kind"] for f in fails] == ["device"] * 4


def test_repeated_device_errors_stay_on_the_card(cm, x0, baseline,
                                                 tmp_path):
    """Past ``degrade_after`` device errors in a row at one chain (where
    the JAX package moves to its NumPy oracle) the port keeps retrying
    the same sampler: no degradation, the same backend, bitwise."""
    faults.inject("xla_error", point="sample.loop", at_row=30, times=4)
    g = _gibbs(cm)
    chain, rep = run_supervised(g, x0, tmp_path, NITER, save_every=SAVE,
                                degrade_after=2, sleep=_nosleep)
    assert np.array_equal(chain, baseline)
    assert rep.degradations == 0 and rep.backend == "torch"
    assert [f["kind"] for f in rep.failures] == ["device"] * 4
    assert telemetry.get("degradations") == 0
    assert g.cm.device.type == "cpu"
    assert not any(e.get("event") == "backend_degraded"
                   for e in _events(tmp_path))


def test_repeated_device_errors_stay_on_the_card_multichain(cm, tmp_path):
    """The same past ``degrade_after`` at three chains: the same sampler,
    bitwise the uninterrupted three-chain run, no event."""
    kw = dict(nchains=3)
    x3 = _gibbs(cm, **kw).initial_sample(torch.Generator().manual_seed(0))
    base = _gibbs(cm, **kw).sample(x3, outdir=tmp_path / "base",
                                   niter=NITER, save_every=SAVE)
    faults.inject("xla_error", point="sample.loop", at_row=30, times=4)
    g = _gibbs(cm, **kw)
    chain, rep = run_supervised(g, x3, tmp_path / "c", NITER,
                                save_every=SAVE, degrade_after=2,
                                sleep=_nosleep)
    assert np.array_equal(chain, base)
    assert rep.degradations == 0 and rep.backend == "torch"
    assert [f["kind"] for f in rep.failures] == ["device"] * 4
    assert telemetry.get("degradations") == 0
    assert integrity.read_manifest(tmp_path / "c")["layout"][
        "backend"] == "torch"
    assert not any(e.get("event") == "backend_degraded"
                   for e in _events(tmp_path / "c"))


def test_kill_mid_run_multichain_recovers_bitwise(cm, x0, tmp_path):
    """The torn-checkpoint kill at three chains and four sweeps per chunk:
    rollback and a bitwise replay of every chain."""
    kw = dict(nchains=3, chunk_size=4)
    x3 = _gibbs(cm, **kw).initial_sample(torch.Generator().manual_seed(0))
    base = _gibbs(cm, **kw).sample(x3, outdir=tmp_path / "base", niter=24,
                                   save_every=4)
    faults.inject("crash", point="chainstore.between_replaces", at_row=16)
    chain, rep = run_supervised(_gibbs(cm, **kw), x3, tmp_path / "c", 24,
                                save_every=4, sleep=_nosleep)
    assert np.array_equal(chain, base)
    assert rep.retries == 1
    assert telemetry.get("rollbacks") == 1


def test_same_object_retry_equals_fresh_object_resume(cm, x0, tmp_path):
    """A device error raised in the driver with a chunk queued: retrying
    on the same sampler object (its carry, graphs, records and counters
    from the failed attempt) gives the chain, bchain and checkpoint state
    that a fresh object resumed from the same checkpoint gives."""
    kw = dict(chunk_size=4)
    faults.inject("xla_error", point="dispatch.chunk", at_row=20)
    g = _gibbs(cm, **kw)
    with pytest.raises(faults.InjectedDeviceError):
        g.sample(x0, outdir=tmp_path / "same", niter=NITER, save_every=8)
    assert g.driver.it_cur == 16
    shutil.copytree(tmp_path / "same", tmp_path / "fresh")
    same = g.sample(x0, outdir=tmp_path / "same", niter=NITER,
                    save_every=8, resume=True)
    fresh_g = _gibbs(cm, **kw)
    fresh = fresh_g.sample(x0, outdir=tmp_path / "fresh", niter=NITER,
                           save_every=8, resume=True)
    assert np.array_equal(same, fresh)
    assert np.array_equal(g.bchain, fresh_g.bchain)
    with np.load(tmp_path / "same" / "adapt.npz") as a, \
            np.load(tmp_path / "fresh" / "adapt.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k
    assert g.driver.b_mh_sweeps == fresh_g.driver.b_mh_sweeps


# -- the three shared schedules, against the JAX package ---------------------

SCHEDULES = {
    "nan_rows": [dict(kind="nan_rows", at_row=45)],
    "device_x3": [dict(kind="xla_error", point="sample.loop", at_row=30,
                       times=3)],
    "sigterm": [dict(kind="sigterm_at_seam", point="sample.loop",
                     at_row=30, seconds=60.0)],
}


def _report(rep, delays):
    return {"status": rep.status, "attempts": rep.attempts,
            "retries": rep.retries, "refolds": rep.refolds,
            "classes": [f["kind"] for f in rep.failures],
            "delays": delays}


def _event_rows(outdir):
    return [(e["event"], e.get("row"), e.get("rows"))
            for e in _events(outdir) if "event" in e]


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_report_and_events_match_the_jax_package(cm, x0, synth_pta,
                                                 tmp_path, name):
    from pulsar_timing_gibbsspec_tpu.runtime import faults as jfaults
    from pulsar_timing_gibbsspec_tpu.runtime import preemption as jpre
    from pulsar_timing_gibbsspec_tpu.runtime import \
        run_supervised as jrun_supervised
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import \
        PTABlockGibbs as JaxGibbs

    got = {}
    for side, mod, pre, sup in (("jax", jfaults, jpre, jrun_supervised),
                                ("torch", faults, preemption,
                                 run_supervised)):
        mod.clear()
        pre.reset()
        for f in SCHEDULES[name]:
            mod.inject(**f)
        if side == "jax":
            g = JaxGibbs(synth_pta, backend="numpy", seed=1, progress=False)
            start = synth_pta.initial_sample(np.random.default_rng(0))
        else:
            g, start = _gibbs(cm), x0
        delays = []
        _, rep = sup(g, start, tmp_path / side, NITER, save_every=SAVE,
                     backoff_base=0.5, backoff_cap=4.0, sleep=delays.append)
        got[side] = (_report(rep, delays), _event_rows(tmp_path / side))
        mod.clear()
        pre.reset()
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
