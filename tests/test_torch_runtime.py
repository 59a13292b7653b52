"""The port's runtime modules against the JAX package's, on the CPU.

Exact unless stated: ``backoff_delay`` over retries 1-10 and several
seeds and settings; ``classify_failure`` on a table of exception types
both packages see (and on torch's own errors, the "no CUDA device" case
a ``user`` failure); the ``SentinelMonitor`` events, summaries and
raises on one health sequence; ``chunk_health`` on the same numpy stacks
(``finite`` and ``rho_ok`` equal, ``move_frac`` equal in float32); the
watchdog's deadlines after one ``observe`` sequence.  A port checkpoint
refolded by ``refold_checkpoint_key`` passes the JAX package's
``integrity.verify`` and resumes on another stream; the port's
``chain.h5`` is the JAX ``export_hdf5`` of the same arrays and names in
datasets, dtypes and attributes (the backend attribute aside).
"""

import numpy as np
import pytest
import torch

from test_torch_cases import small_psrs

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1, 7, 2024])
@pytest.mark.parametrize("base,cap,jitter", [(0.5, 30.0, 0.25),
                                             (0.1, 1.0, 0.0),
                                             (2.0, 10.0, 0.5)])
def test_backoff_delay_matches_jax(seed, base, cap, jitter):
    from pulsar_timing_gibbsspec_torch.runtime import backoff_delay
    from pulsar_timing_gibbsspec_tpu.runtime import backoff_delay as jax_bd

    for retry in range(1, 11):
        assert (backoff_delay(retry, base, cap, jitter, seed=seed)
                == jax_bd(retry, base, cap, jitter, seed=seed)), retry


def _shared_failures():
    """Exceptions both packages classify (the port's own stand-ins for
    the shared classes beside the JAX package's)."""
    from pulsar_timing_gibbsspec_torch.runtime import (
        CheckpointError, ChainDivergence, DispatchStall, Preempted, faults)
    from pulsar_timing_gibbsspec_tpu.runtime import (
        CheckpointError as JCheckpointError, ChainDivergence as JDivergence,
        DispatchStall as JStall, Preempted as JPreempted, faults as jfaults)

    XlaRuntimeError = type("XlaRuntimeError", (RuntimeError,), {})
    InternalError = type("InternalError", (Exception,), {})
    plain = [ValueError("bad shape"), TypeError("x"), KeyError("k"),
             IndexError("i"), AttributeError("a"), NotImplementedError(),
             AssertionError(), OSError("disk"), FileNotFoundError("f"),
             RuntimeError("resume checkpoint was written with nchains=2"),
             RuntimeError("device lost mid-run"),
             RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
             RuntimeError("an internal error"),
             RuntimeError("transfer guard disallows this"),
             XlaRuntimeError("INTERNAL: boom"), InternalError("x"),
             FloatingPointError("nan"), KeyboardInterrupt(), Exception("?")]
    paired = [(CheckpointError("c"), JCheckpointError("c")),
              (ChainDivergence("d", row=3), JDivergence("d", row=3)),
              (DispatchStall("s"), JStall("s")),
              (Preempted("p"), JPreempted("p")),
              (faults.InjectedCrash("k"), jfaults.InjectedCrash("k")),
              (faults.InjectedDeviceError("CUDA error: injected"),
               jfaults.XlaRuntimeError("INTERNAL: injected"))]
    return [(e, e) for e in plain] + paired


def test_classify_failure_matches_jax_on_shared_types():
    from pulsar_timing_gibbsspec_torch.runtime import classify_failure
    from pulsar_timing_gibbsspec_tpu.runtime import classify_failure as jcf

    for ours, theirs in _shared_failures():
        assert classify_failure(ours) == jcf(theirs), repr(ours)


@pytest.mark.parametrize("exc,kind", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     "device"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "device"),
    (RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasGemm"),
     "device"),
    (RuntimeError("cusolver error: CUSOLVER_STATUS_INTERNAL_ERROR"),
     "device"),
    (RuntimeError("unspecified launch failure"), "device"),
    (RuntimeError("no CUDA device is available; pass device='cpu' to run "
                  "the port's plain PyTorch path on the CPU"), "user"),
    (RuntimeError("Expected all tensors to be on the same device, but "
                  "found at least two devices, cuda:0 and cpu!"), "user"),
    (AssertionError("Torch not compiled with CUDA enabled"), "user"),
    (RuntimeError("CUDA graph capture failed"), "device"),
])
def test_classify_failure_of_torch_errors(exc, kind):
    from pulsar_timing_gibbsspec_torch.runtime import classify_failure

    assert classify_failure(exc) == kind


def test_classify_the_port_s_no_device_error():
    """The entry points' own refusal without a card is a ``user``
    failure: retrying it would only sleep through the backoff."""
    from pulsar_timing_gibbsspec_torch.config import resolve_device
    from pulsar_timing_gibbsspec_torch.runtime import classify_failure

    if torch.cuda.is_available():
        pytest.skip("a card is present: resolve_device does not refuse")
    with pytest.raises(RuntimeError) as err:
        resolve_device("cuda")
    assert classify_failure(err.value) == "user"


def _health_sequence():
    """Per-chunk health dicts: healthy, a collapsing chain, a rho breach,
    then chain 1 stuck for three chunks."""
    t, f = True, False
    return [
        {"finite": [t, t, t], "move_frac": [1.0, 0.5, 0.25],
         "rho_ok": [t, t, t]},
        {"finite": [t, t, f], "move_frac": [0.01, 0.5, 0.9],
         "rho_ok": [t, t, t]},
        {"finite": [t, t, t], "move_frac": [1.0, 0.0, 0.015],
         "rho_ok": [t, f, t]},
        {"finite": [t, t, t], "move_frac": [1.0, 0.0, 1.0],
         "rho_ok": [t, t, t]},
        {"finite": [t, t, t], "move_frac": [0.5, 0.0, 1.0],
         "rho_ok": [t, t, t]},
    ]


def test_sentinel_monitor_matches_jax():
    from pulsar_timing_gibbsspec_torch.runtime import sentinels, telemetry
    from pulsar_timing_gibbsspec_tpu.runtime import sentinels as jsent
    from pulsar_timing_gibbsspec_tpu.runtime import telemetry as jtel

    mons = (sentinels.SentinelMonitor(), jsent.SentinelMonitor())
    telemetry.reset()
    jtel.reset()
    for i, h in enumerate(_health_sequence()):
        outs = []
        for mon, exc_t in zip(mons, (sentinels.ChainDivergence,
                                     jsent.ChainDivergence)):
            hh = {k: np.asarray(v) for k, v in h.items()}
            try:
                outs.append(("events", mon.observe(hh, 100 * (i + 1))))
            except exc_t as exc:
                outs.append(("raise", str(exc), exc.row, exc.what))
            outs[-1] += (mon.last,)
        assert outs[0] == outs[1], i
    assert outs[0][0] == "raise"
    assert mons[0].events == mons[1].events
    assert telemetry.snapshot() == jtel.snapshot()
    telemetry.reset()
    jtel.reset()


def _stacks(rng, n=7, C=4, nx=9, nb=11):
    xs = rng.standard_normal((n, C, nx)) * 0.3 - 3.0
    bs = rng.standard_normal((n, C, nb))
    xs[:, 2] = xs[0, 2]                 # chain 2 stuck
    xs[3:, 1, 0] = xs[2, 1, 0]          # chain 1 moves in the rest only
    xs[4, 3, 5] = np.nan                # chain 3 not finite
    bs[1, 0, 2] = np.inf                # chain 0's b not finite
    xs[5, 1, 7] = -5.2                  # chain 1 breaches the lower bound
    xs[6, 0, 6] = -2.0 + 0.5e-6         # inside the tolerance
    return xs, bs


@pytest.mark.parametrize("n", [1, 2, 7])
@pytest.mark.parametrize("rho", [True, False])
def test_chunk_health_matches_jax(n, rho):
    from pulsar_timing_gibbsspec_torch.runtime.sentinels import chunk_health
    from pulsar_timing_gibbsspec_tpu.runtime.sentinels import \
        chunk_health as jax_health

    xs, bs = _stacks(np.random.default_rng(n))
    xs, bs = xs[:n], bs[:n]
    args = (np.array([5, 6, 7]), -5.0, -2.0) if rho else (None, None, None)
    ours = chunk_health(torch.as_tensor(xs), torch.as_tensor(bs), *args)
    theirs = jax_health(xs, bs, *args)
    for k in ("finite", "rho_ok"):
        assert np.array_equal(ours[k].numpy(), np.asarray(theirs[k])), k
    assert ours["move_frac"].dtype == torch.float32
    assert np.array_equal(ours["move_frac"].numpy(),
                          np.asarray(theirs["move_frac"], np.float32))


def test_watchdog_deadlines_match_jax():
    from pulsar_timing_gibbsspec_torch.runtime import DispatchWatchdog
    from pulsar_timing_gibbsspec_tpu.runtime import \
        DispatchWatchdog as JaxWatchdog

    kw = dict(k=3.0, floor_s=2.0, first_floor_s=50.0, ema_alpha=0.3)
    ours, theirs = DispatchWatchdog(**kw), JaxWatchdog(**kw)
    seq = [(4.1, 100), (3.7, 100), (0.2, 100), (9.0, 100), (1.0, 40),
           (2.5, 40), (0.01, 40)]
    assert ours.deadline(100) == theirs.deadline(100) == 50.0
    for dt, n in seq:
        ours.observe(dt, n)
        theirs.observe(dt, n)
        assert ours.ema == theirs.ema
        for m in (1, 40, 100):
            assert ours.deadline(m) == theirs.deadline(m), (dt, n, m)
    with pytest.raises(ValueError, match="exceed 1"):
        DispatchWatchdog(k=1.0)


def test_watchdog_raises_past_its_deadline_and_polls_done():
    from pulsar_timing_gibbsspec_torch.runtime import (DispatchStall,
                                                       DispatchWatchdog,
                                                       telemetry)

    telemetry.reset()
    wd = DispatchWatchdog(first_floor_s=0.2, poll_s=0.01)
    assert wd.call(lambda: 7, done=lambda: True) == 7
    with pytest.raises(DispatchStall, match="deadline"):
        wd.call(lambda: None, what="wait", done=lambda: False)
    assert telemetry.get("watchdog_stalls") == 1
    assert telemetry.get("watchdog_soft") == 1
    with pytest.raises(ZeroDivisionError):
        wd.call(lambda: 1 / 0)
    telemetry.reset()


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    from pulsar_timing_gibbsspec_torch import (PTABlockGibbs,
                                               build_crn_spectrum)

    cm = build_crn_spectrum(small_psrs(), 4, 4, device="cpu")

    def gibbs():
        return PTABlockGibbs(cm, nchains=2, device="cpu", seed=5,
                             warmup_sweeps=3, white_adapt_iters=120,
                             chunk_size=4, progress=False)

    g = gibbs()
    x0 = g.initial_sample(torch.Generator().manual_seed(4))
    d = tmp_path_factory.mktemp("run")
    g.sample(x0, outdir=d / "split", niter=20, save_every=4)
    g.sample(x0, outdir=d / "whole", niter=36, save_every=4, hdf5=True)
    return gibbs, x0, g, d


def test_refolded_checkpoint_verifies_in_jax_and_takes_another_stream(
        run_dir, tmp_path):
    import shutil

    from pulsar_timing_gibbsspec_torch.runtime import sentinels, telemetry
    from pulsar_timing_gibbsspec_torch.sampler.driver import (refold_seed,
                                                              stream_seed)
    from pulsar_timing_gibbsspec_tpu.runtime import integrity as jint

    gibbs, x0, g, d = run_dir
    out = tmp_path / "c"
    shutil.copytree(d / "split", out)
    with np.load(out / "adapt.npz") as z:
        before = {k: z[k] for k in z.files}
    telemetry.reset()
    assert sentinels.refold_checkpoint_key(out, salt=3)
    assert telemetry.get("refolds") == 1
    assert jint.verify(out)["ok"]
    with np.load(out / "adapt.npz") as z:
        after = {k: z[k] for k in z.files}
    assert int(after["seed"]) == refold_seed(5, 3) == stream_seed(
        stream_seed(5, -2), 3)
    assert after["seed"].dtype == before["seed"].dtype
    for k in before:
        if k != "seed":
            assert np.array_equal(after[k], before[k]), k
    chain = gibbs().sample(x0, outdir=out, niter=36, save_every=4,
                           resume=True)
    whole = np.load(d / "whole" / "chain.npy")
    assert np.array_equal(chain[:20], whole[:20])
    assert not np.array_equal(chain[21:], whole[21:])
    assert not sentinels.refold_checkpoint_key(tmp_path / "none", salt=1)


def test_hdf5_matches_the_jax_export(run_dir, tmp_path):
    import h5py

    from pulsar_timing_gibbsspec_tpu.sampler.chains import \
        ChainStore as JaxStore

    _, _, g, d = run_dir
    JaxStore(tmp_path, g.param_names, g.b_param_names).export_hdf5(
        g.chain, g.bchain, len(g.chain), extra_attrs={"backend": "numpy"})
    with h5py.File(d / "whole" / "chain.h5") as a, \
            h5py.File(tmp_path / "chain.h5") as b:
        assert sorted(a.keys()) == sorted(b.keys()) == [
            "b_params", "bchain", "chain", "params"]
        for k in a.keys():
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert np.array_equal(a[k][()], b[k][()]), k
        assert dict(a.attrs) == {**dict(b.attrs), "backend": "torch"}
        assert a.attrs["niter"] == 36
    assert np.array_equal(np.load(d / "whole" / "chain.npy"), g.chain)


def test_hdf5_without_h5py_raises(run_dir, tmp_path, monkeypatch):
    import sys

    from pulsar_timing_gibbsspec_torch.sampler.chains import ChainStore

    _, _, g, _ = run_dir
    monkeypatch.setitem(sys.modules, "h5py", None)
    store = ChainStore(tmp_path, g.param_names, g.b_param_names)
    with pytest.raises(RuntimeError, match="requires h5py"):
        store.export_hdf5(g.chain, g.bchain, 4)
    assert not (tmp_path / "chain.h5").exists()
