"""The port's ``obs`` package against the JAX package's on the same
inputs: the device sketch (``update``, and the per-sweep fold the driver
runs), its host finalizers (``finalize``, ``moment_split_rhat``,
``RollingDiag``), the R-hats, the trace recorder and the Prometheus
writer; and the driver's trace spans.

Tolerances: the sketch's fold of a whole stack is the JAX arithmetic in
float64, 1e-12 relative (the lagged sums are summed in another order);
folded one sweep at a time it is the same statistic merged in another
order, 1e-9 relative on the moments (m2 and the co-moments lose the
digits the merge cancels) and 1e-12 on the lagged sums; the
finalizers and R-hats are NumPy on equal inputs, 1e-12 (the normal
quantile is ``torch.special.ndtri`` against JAX's, 1e-12).
"""

import json

import numpy as np
import pytest
import torch

from pulsar_timing_gibbsspec_torch.obs import (convergence, metrics, sketch,
                                               summary, trace)
from pulsar_timing_gibbsspec_torch.runtime import telemetry
from pulsar_timing_gibbsspec_torch.sampler.compiled import (
    sketch_state_from_arrays)
from test_torch_cases import close, models, small_psrs

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's obs modules, float64 on."""
    from pulsar_timing_gibbsspec_tpu.config import settings

    settings.apply()
    from pulsar_timing_gibbsspec_tpu.obs import convergence as jconv
    from pulsar_timing_gibbsspec_tpu.obs import metrics as jmet
    from pulsar_timing_gibbsspec_tpu.obs import sketch as jsk
    from pulsar_timing_gibbsspec_tpu.obs import summary as jsum
    return jsk, jsum, jconv, jmet


def _specs(jsk, D=4, cross=3, lags=16, nx=7):
    """One spec on both sides: D channels of an nx-wide state, two move
    groups."""
    kw = dict(channels=np.arange(D), names=tuple(
        f"gw_crn_log10_rho_{i}" for i in range(D)), cross_k=cross,
        lags=lags)
    groups = (("rho", np.arange(D)), ("white", np.arange(D, nx)))
    return (sketch.SketchSpec(groups=groups, **kw),
            jsk.SketchSpec(groups=tuple((n, g.astype(np.int32))
                                        for n, g in groups),
                           **{**kw, "channels": kw["channels"].astype(
                               np.int32)}))


def _stream(rng, n, C, nx, phi=0.7):
    """AR(1) chains (n, C, nx) with coordinates 5 and 6 frozen in
    stretches (moves of < 1)."""
    x = np.zeros((n, C, nx))
    e = rng.standard_normal((n, C, nx)) * np.sqrt(1 - phi ** 2)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + e[t]
    x[:, :, 5:] = np.repeat(x[::3, :, 5:], 3, axis=0)[:n]
    return 3.0 + x


def _jax_stream(jsk, spec, xs, x0, chunks):
    import jax.numpy as jnp

    st = jsk.init_state(spec, xs.shape[1])
    snaps, row = [], 0
    for c in chunks:
        blk = jnp.asarray(xs[row:row + c])
        st = jsk.update(spec, st, jnp.asarray(x0), blk)
        x0 = xs[row + c - 1]
        row += c
        snaps.append((float(np.asarray(st["n"])),
                      np.asarray(st["mean"], np.float64),
                      np.asarray(st["m2"], np.float64)))
    return {k: np.asarray(v) for k, v in st.items()}, snaps


def test_update_matches_jax(jx):
    """The fold of whole stacks on a grid of uneven chunks."""
    jsk = jx[0]
    spec_t, spec_j = _specs(jsk)
    rng = np.random.default_rng(0)
    xs = _stream(rng, 57, 3, 7)
    x0 = xs[0] - 0.5
    ref, _ = _jax_stream(jsk, spec_j, xs, x0, (7, 13, 37))
    st = sketch.init_state(spec_t, 3)
    prev, row = torch.tensor(x0), 0
    for c in (7, 13, 37):
        blk = torch.tensor(xs[row:row + c])
        st = sketch.update(spec_t, st, prev, blk)
        prev, row = blk[-1], row + c
    for k, v in ref.items():
        close(st[k], v, 1e-12, atol=1e-12 * max(np.abs(v).max(), 1.0))
    # the port's state is the JAX state and the lagged sums' shift
    assert set(st) == set(ref) | {"shift"}
    assert (sketch.state_bytes(spec_t, 3)
            == jsk.state_bytes(spec_j, 3) + 8 * 3 * spec_t.D
            == sum(v.numel() * 8 for v in st.values()))


def test_per_sweep_fold_matches_jax_chunk_update(jx):
    """The driver's fold (one sweep at a time, in place, from the state
    entering the first sweep) against the JAX chunk fold of the same
    stream."""
    jsk = jx[0]
    spec_t, spec_j = _specs(jsk, lags=8)
    rng = np.random.default_rng(1)
    xs = _stream(rng, 40, 2, 7)
    x0 = xs[0].copy()
    ref, _ = _jax_stream(jsk, spec_j, xs, x0, (40,))
    st = sketch.init_state(spec_t, 2)
    prev = torch.tensor(x0)
    index = sketch.spec_index(spec_t, "cpu")
    for t in range(40):
        sketch.fold_(spec_t, st, prev, torch.tensor(xs[t]), index)
    assert torch.equal(prev, torch.tensor(xs[-1]))
    for k, v in ref.items():
        rtol = 1e-12 if k in ("n", "lag", "tail", "move", "moven") else 1e-9
        close(st[k], v, rtol, atol=rtol * max(np.abs(v).max(), 1.0))


def test_spec_and_state_carry_match_jax(jx):
    jsk = jx[0]
    cmj, cmt = models()
    for kw in ({}, {"channels": 5, "cross": 2, "lags": 32}):
        a, b = sketch.make_sketch_spec(cmt, **kw), jsk.make_sketch_spec(
            cmj, **kw)
        assert np.array_equal(a.channels, b.channels)
        assert a.names == b.names and a.cross_k == b.cross_k
        assert a.lags == b.lags
        assert [(n, list(g)) for n, g in a.groups] == [
            (n, list(g)) for n, g in b.groups]
    st_j = {k: np.asarray(v) for k, v in jsk.init_state(b, 4).items()}
    st_j["lag"] = st_j["lag"] + 1.5
    st_t = sketch_state_from_arrays(st_j, "cpu")
    for k, v in st_j.items():
        assert st_t[k].dtype == torch.float64
        close(st_t[k], v, 0)
    assert torch.equal(st_t["shift"], torch.zeros_like(st_t["mean"]))
    with pytest.raises(ValueError, match="lacks tail"):
        sketch_state_from_arrays({k: v for k, v in st_j.items()
                                  if k != "tail"}, "cpu")


def test_finalize_and_moment_rhat_match_jax(jx):
    jsk, jsum = jx[0], jx[1]
    spec_t, spec_j = _specs(jsk, lags=32)
    rng = np.random.default_rng(2)
    xs = _stream(rng, 600, 3, 7)
    xs[300:, 1, :4] += 2.0               # chain 1 shifts half way
    st, snaps = _jax_stream(jsk, spec_j, xs, xs[0], (60,) * 10)
    got, want = summary.finalize(spec_t, st), jsum.finalize(spec_j, st)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            for g in v:
                close(got[k][g], v[g], 1e-12)
        elif isinstance(v, (np.ndarray, float)) and not isinstance(v, bool):
            close(got[k], v, 1e-12)
        else:
            assert got[k] == v, k
    r_t = summary.moment_split_rhat(snaps, st)
    r_j = jsum.moment_split_rhat(snaps, st)
    close(r_t, r_j, 1e-12)
    assert r_t.max() > 1.1
    # short streams: the finalizer's and the split's early returns
    st4, snaps4 = _jax_stream(jsk, spec_j, xs[:3], xs[0], (3,))
    assert (summary.finalize(spec_t, st4)["ess_total"]
            == jsum.finalize(spec_j, st4)["ess_total"] == 0.0)
    assert summary.moment_split_rhat(snaps4, st4) is None


def test_shifted_lag_sums_fix_the_act_far_from_zero(jx):
    """The JAX sketch sums raw lagged products, an estimator that is not
    shift-invariant: on AR(1) chains at mean -7 and sd 0.3 (a common
    log10_rho's scale) and 240 sweeps (a steady run of ``chip_smoke.py``)
    its ACT is far from the host's Sokal ACT.  The port's lagged sums,
    shifted by the first folded state, hold the JAX package's acceptance
    bound (within 10% of the host, ``tests/test_obs.py``) there, and give
    the same ACT, to 1e-9, for the chains moved by a constant."""
    from pulsar_timing_gibbsspec_torch.ops.acf import integrated_act_columns

    jsk, jsum = jx[0], jx[1]
    spec_t, spec_j = _specs(jsk, D=4, cross=2, lags=64)
    n, C = 240, 16
    rng = np.random.default_rng(6)
    xs = -7.0 + 0.3 * (_stream(rng, n, C, 7) - 3.0)
    host = np.median(integrated_act_columns(xs[:, :, :4].reshape(n, -1)))

    def port_act(xs):
        st = sketch.init_state(spec_t, C)
        sketch.set_shift_(spec_t, st, torch.tensor(xs[0]))
        for lo in range(0, n, 60):
            st = sketch.update(spec_t, st, torch.tensor(xs[max(lo - 1, 0)]),
                               torch.tensor(xs[lo:lo + 60]))
        return summary.finalize(spec_t, {k: v.numpy()
                                         for k, v in st.items()})["act"]

    act = port_act(xs)
    assert abs(np.median(act) / host - 1.0) < 0.10
    close(port_act(xs + 5.0), act, 1e-9)
    ref, _ = _jax_stream(jsk, spec_j, xs, xs[0], (60,) * 4)
    jact = np.median(jsum.finalize(spec_j, ref)["act"])
    assert abs(jact / host - 1.0) > 0.2


def test_rolling_diag_matches_jax(jx):
    jsum = jx[1]
    rng = np.random.default_rng(5)
    rows = _stream(rng, 300, 1, 3)[:, 0, :]
    d_t, d_j = summary.RollingDiag(cap=256), jsum.RollingDiag(cap=256)
    for i in range(0, 300, 25):
        d_t.observe(rows[i:i + 25], now=float(i))
        d_j.observe(rows[i:i + 25], now=float(i))
    for fn in ("row_rate", "act", "ess_per_sec", "rhat_max", "accept_rate"):
        close(getattr(d_t, fn)(), getattr(d_j, fn)(), 1e-9)
    assert 0.0 < d_t.accept_rate() <= 1.0 and d_t.act() > 1.0


def test_rhats_match_jax(jx):
    jconv = jx[2]
    rng = np.random.default_rng(3)
    iid = rng.standard_normal((4, 301))
    iid[:, 5] = iid[:, 6]                          # ties
    shifted = iid + np.arange(4)[:, None] * 0.7
    for a in (iid, shifted, iid * (1.0 + np.arange(4))[:, None]):
        close(convergence.rank_normalize(a), jconv.rank_normalize(a),
              1e-12)
        close(convergence.split_rhat(a), jconv.split_rhat(a), 1e-12)
        close(convergence.rank_normalized_split_rhat(a),
              jconv.rank_normalized_split_rhat(a), 1e-12)
    slab = rng.standard_normal((3, 200, 5))
    close(convergence.ensemble_rhat(slab), jconv.ensemble_rhat(slab),
          1e-12)
    for fn, arg in ((convergence.split_rhat, slab),
                    (convergence.ensemble_rhat, iid)):
        with pytest.raises(ValueError):
            fn(arg)
    assert convergence.rank_normalized_split_rhat(shifted) > 1.2


def test_prometheus_render_matches_jax(jx):
    jmet = jx[3]
    counts = {"hits": 3, 'hits{job="a b"}': 1, "z-ops": 7}
    gauges = {"speed": 1.5, 'depth{q="x\\"y"}': 2.0, "nan": float("nan"),
              "up": float("inf"), 'g{t="cr\\rlf\\n"}': -float("inf")}
    assert (metrics.render(counts, gauges, prefix="t")
            == jmet.render(counts, gauges, prefix="t"))
    for key in ('m{a="1",b="x"}', "plain", 'q{v="\\\\\\n"}'):
        assert metrics.split_key(key) == jmet.split_key(key)
    telemetry.reset("tobs_")
    telemetry.gauge("tobs_ess", 12.5, job="j1")
    telemetry.incr("tobs_hits", 2)
    body = metrics.render_telemetry()
    telemetry.reset("tobs_")
    assert 'ptgibbs_tobs_ess{job="j1"} 12.5' in body
    assert "ptgibbs_tobs_hits_total 2" in body


# ---------------------------------------------------------------------------
# the trace recorder (the JAX package's cases, tests/test_obs.py)


def test_trace_spans_nest_and_export(tmp_path):
    sink_lines = []
    trace.enable(lambda ev: sink_lines.append(ev))
    try:
        with trace.span("outer", row=1):
            with trace.span("inner"):
                pass
        trace.instant("mark", x=2)
        evs = trace.events()
    finally:
        path = trace.write_chrome(tmp_path / "t.json")
        trace.disable()
    names = [e["name"] for e in evs]
    assert names == ["inner", "outer", "mark"]
    outer, inner = evs[1], evs[0]
    assert outer["ph"] == "X" and inner["ph"] == "X"
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert outer["args"] == {"row": 1}
    doc = json.loads((tmp_path / "t.json").read_text())
    assert path == str(tmp_path / "t.json")
    assert len(doc["traceEvents"]) == 3
    assert [ev["name"] for ev in sink_lines] == names


def test_trace_disabled_is_free():
    trace.disable()
    before = trace.events()
    a = trace.span("x")
    b = trace.span("y", k=1)
    assert a is b
    with a:
        pass
    trace.instant("z")
    assert trace.events() == before


def test_trace_ring_bounded_and_dropped(monkeypatch):
    monkeypatch.setattr(trace, "MAX_EVENTS", 5)
    trace.enable()
    try:
        for i in range(12):
            trace.instant(f"e{i}")
        evs = trace.events()
        assert [e["name"] for e in evs] == [f"e{i}" for i in range(7, 12)]
        assert trace.dropped() == 7
        assert any(e["name"] == "trace.ring_dropped"
                   and e["args"]["dropped"] == 7
                   for e in trace.to_chrome()["traceEvents"])
    finally:
        trace.disable()


def test_trace_jsonl_sink_flushes_on_disable(tmp_path):
    path = tmp_path / "t.jsonl"
    trace.enable(trace.jsonl_sink(path))
    with trace.span("work", k=1):
        pass
    trace.instant("mark")
    trace.disable()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [ev["name"] for ev in lines] == ["work", "mark"]
    assert lines[0]["event"] == "trace_span" and lines[0]["k"] == 1
    assert lines[0]["ms"] >= 0.0
    assert lines[1]["event"] == "trace_instant"


def test_trace_observer_activates_seams_while_disabled():
    trace.disable()
    before = trace.events()
    seen = []
    trace.add_observer(seen.append)
    try:
        with trace.span("chunk.dispatch"):
            pass
        trace.instant("ping")
    finally:
        trace.remove_observer(seen.append)
    assert [e["name"] for e in seen] == ["chunk.dispatch", "ping"]
    assert trace.events() == before
    assert trace.span("a") is trace.span("b")


# ---------------------------------------------------------------------------
# the driver's seams


def test_driver_spans_and_watchdog_instants(tmp_path):
    """A run with the recorder on shows the JAX driver's span names at
    the port's seams (one warmup, a dispatch, carry sync, d2h and
    writeback per chunk); the watchdog's soft escalation is an instant."""
    import time

    from pulsar_timing_gibbsspec_torch import (PTABlockGibbs,
                                               build_crn_spectrum)
    from pulsar_timing_gibbsspec_torch.runtime.watchdog import \
        DispatchWatchdog

    cm = build_crn_spectrum(small_psrs(), 4, 4, device="cpu")
    g = PTABlockGibbs(cm, nchains=2, device="cpu", seed=0, warmup_sweeps=2,
                      white_adapt_iters=60, chunk_size=5, progress=False)
    x0 = g.initial_sample(torch.Generator().manual_seed(0))
    trace.enable()
    try:
        g.sample(x0, outdir=str(tmp_path), niter=14, save_every=5)
        wd = DispatchWatchdog(first_floor_s=0.4, soft_frac=0.1,
                              poll_s=0.01)
        wd.call(lambda: time.sleep(0.1), what="probe")
        evs = trace.events()
    finally:
        trace.disable()
    names = [e["name"] for e in evs]
    assert names.count("warmup.chunk") == 1
    # steady iterations 3..13 in chunks of 5: three chunks
    for nm in ("chunk.host_prep", "chunk.dispatch", "chunk.carry_sync",
               "chunk.d2h", "chunk.writeback"):
        assert names.count(nm) == 3, nm
    disp = [e for e in evs if e["name"] == "chunk.dispatch"]
    assert [e["args"]["it0"] for e in disp] == [3, 8, 13]
    soft = [e for e in evs if e["name"] == "watchdog.soft"]
    assert len(soft) == 1 and soft[0]["ph"] == "i"
    assert soft[0]["args"]["what"] == "probe"
