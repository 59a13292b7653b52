"""The powerlaw hyper block, piece by piece: the port against the JAX
package on the CPU, on the same numpy inputs.

Cases (all 4 frequency bins):

- R1, the reference's single-pulsar sweep: JSYN02 (flagged NANOGrav,
  basis ECORR), common free spectrum, intrinsic powerlaw red noise;
- R2, the array model of ``bench.py::build_pta`` with powerlaw red in
  place of the red spectrum: the 3 synthetic pulsars of ``small_psrs``;
- R3, ``model_general``'s defaults but varied white noise: JSYN02 with a
  common powerlaw and intrinsic powerlaw red noise.

Checked: the compiled arrays and parameter names field by field (also
with LinearExp amplitude priors); at 16 seeded states, float64, ``phi``,
``phi_hyper_split``, ``red_phi``, ``gw_phi`` and ``lnlike_hyper_fn`` to
rel 1e-12, ``lnprior`` to one float32 ULP of each prior width's log (the
bounds are float32 on both sides), ``lnlike_fullmarg_fn`` to rel 1e-9
(the factors differ in operation order); ``red_mh_block`` over 20 steps
of JAX-drawn noise, with a DE history and without (accept sequence
identical, final state to 1e-12); the adaptation arithmetic and the DE
history window bitwise; the sampling flags against the JAX function;
the initial draws against their priors (KS).
"""

import dataclasses
import functools
import math
import types

import numpy as np
import pytest
import torch

from test_torch_cases import (close, jax_fields, nanograv_psr, same_field,
                              small_psrs, state, t64)

torch.set_num_threads(2)

NB = 4
#: model_general options of each case (the JAX function's names)
CASES = {
    "R1": dict(white_vary=True, common_psd="spectrum", common_components=NB,
               red_var=True, red_psd="powerlaw", red_components=NB),
    "R2": dict(tm_svd=True, white_vary=True, common_psd="spectrum",
               common_components=NB, red_var=True, red_psd="powerlaw",
               red_components=NB),
    "R3": dict(white_vary=True, common_components=NB, red_components=NB),
}


def case_psrs(name):
    return small_psrs() if name == "R2" else [nanograv_psr()]


def jax_model(name, **extra):
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    jp = [Pulsar(**dataclasses.asdict(p)) for p in case_psrs(name)]
    return model_general(jp, **CASES[name], **extra)


@functools.lru_cache(maxsize=None)
def models(name):
    """``(jax_cm, port_cm)`` of a case, the port's from its own
    ``model_general``."""
    from pulsar_timing_gibbsspec_torch import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    return (compile_pta(jax_model(name)),
            model_general(case_psrs(name), device="cpu", **CASES[name]))


def hyper_state(cm, C, seed):
    """:func:`state` with the powerlaw hypers drawn inside their priors
    (log10_A in [-17, -12], gamma in [1, 6]); the first state sits at
    the amplitude prior's corner (-20 red, -18 common) with gamma 0."""
    x = state(cm, C=C, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for j in cm.idx.red:
        nm = cm.param_names[j]
        if "log10_A" in nm:
            x[:, j] = rng.uniform(-17.0, -12.0, C)
            x[0, j] = float(cm.pa[j])
        else:
            x[:, j] = rng.uniform(1.0, 6.0, C)
            x[0, j] = 0.0
    return x


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("upper", [None, "upper_limit", "upper_limit_red"])
def test_model_equals_compile_pta(name, upper):
    """The port's arrays equal ``jax_fields(compile_pta(...))`` field by
    field (``f``, ``df``, ``hyp_ix``, ``red_hyp_ix``, ``gw_f``, ``gw_df``
    included), and the parameter names are the JAX model's."""
    from pulsar_timing_gibbsspec_torch.models.build import model_arrays
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    extra = {} if upper is None else {upper: True}
    pta = jax_model(name, **extra)
    want = jax_fields(compile_pta(pta))
    opts = {k: v for k, v in CASES[name].items() if k != "white_vary"}
    opts.setdefault("common_psd", "powerlaw")
    opts.setdefault("red_psd", "powerlaw")
    got = model_arrays(case_psrs(name), **opts, **extra)
    assert list(got["param_names"]) == list(pta.param_names)
    assert (2 in got["pkind"]) == (upper is not None)
    for key, v in want.items():
        if key == "components":
            assert len(v) == len(got[key])
            for c, d in zip(v, got[key]):
                for k in c:
                    same_field(c[k], d[k], f"components.{k}")
        elif key in ("dtype", "cdtype"):
            assert np.dtype(v) == np.dtype(got[key])
        else:
            same_field(v, got[key], key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_priors_and_phi_match_jax(name):
    """16 states: phi (float64 and float32), phi_hyper_split's parts,
    red_phi, gw_phi at rel 1e-12 (float32 phi: 2e-6), lnprior to one
    float32 ULP per parameter."""
    import jax
    import jax.numpy as jnp

    cmj, cmt = models(name)
    x = hyper_state(cmt, 16, seed=1)

    def jax_side(x):
        static, dyn = cmj.phi_hyper_split(x)
        return dict(phi=cmj.phi(x), phi32=cmj.phi(x, dtype=jnp.float32),
                    static=static, dyn=dyn(x), red_phi=cmj.red_phi(x),
                    gw_phi=cmj.gw_phi(x), lnprior=cmj.lnprior(x))

    ref = {k: np.asarray(v)
           for k, v in jax.jit(jax.vmap(jax_side))(x).items()}
    xt = t64(x)
    static, dyn = cmt.phi_hyper_split(xt)
    close(cmt.phi(xt), ref["phi"], 1e-12)
    close(cmt.phi(xt, dtype=torch.float32), ref["phi32"], 2e-6)
    close(static, ref["static"], 1e-12)
    close(dyn(xt), ref["dyn"], 1e-12)
    close(cmt.red_phi(xt), ref["red_phi"], 1e-12)
    close(cmt.gw_phi(xt), ref["gw_phi"], 1e-12)
    close(cmt.lnprior(xt), ref["lnprior"], 0, atol=cmt.nx * 4 * 2.0 ** -23)
    assert torch.isfinite(cmt.phi(xt)).all() and (cmt.phi(xt) > 0).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_hyper_likelihoods_match_jax(name):
    """16 states: lnlike_hyper_fn (with and without phi_fn) at rel
    1e-12; lnlike_fullmarg_fn at rel 1e-9, the Gram of each state's white
    noise from the exact widening Gram on both sides."""
    import jax

    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models(name)
    x = hyper_state(cmt, 16, seed=2)
    b = np.random.default_rng(3).normal(size=(16, cmt.P, cmt.Bmax)) * 1e-7

    def jax_side(x, b):
        _, dyn = cmj.phi_hyper_split(x)
        TNT, d = jb.tnt_d_x(cmj, x, cmj.ndiag(x))
        return (jb.lnlike_hyper_fn(cmj, x, b),
                jb.lnlike_hyper_fn(cmj, x, b, phi_fn=dyn),
                jb.lnlike_fullmarg_fn(cmj, x, TNT, d))

    hj, hjd, fj = (np.asarray(v)
                   for v in jax.jit(jax.vmap(jax_side))(x, b))
    xt, bt = t64(x), t64(b)
    _, dyn = cmt.phi_hyper_split(xt)
    close(blocks.lnlike_hyper_fn(cmt, xt, bt), hj, 1e-12)
    close(blocks.lnlike_hyper_fn(cmt, xt, bt, phi_fn=dyn), hjd, 1e-12)
    TNT, d = blocks.tnt_d_x(cmt, xt, cmt.ndiag(xt))
    close(blocks.lnlike_fullmarg_fn(cmt, xt, TNT, d), fj, 1e-9)


def jax_red_noise(cmj, keys, nsteps, H):
    """The noise JAX ``red_mh_block`` draws from each chain's key, as a
    port :class:`RedNoise` (steps, C, ...)."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_torch.sampler.blocks import RedNoise
    from pulsar_timing_gibbsspec_tpu.sampler.jax_backend import (_SCALE_P,
                                                                 _SCALES)

    d = len(cmj.idx.red)
    f64 = jnp.float64
    scales, probs = jnp.asarray(_SCALES, f64), jnp.asarray(_SCALE_P, f64)

    def step(k):
        k0, k1, k2, k3, k4, k5, k6, k7, k8 = jr.split(k, 9)
        ka, kb, kg = jr.split(k5, 3)
        a = jr.randint(ka, (), 0, H)
        return dict(
            r=jr.uniform(k0), j=jr.randint(k1, (), 0, d),
            eps_scam=jr.normal(k2, dtype=f64),
            z_am=jr.normal(k6, (d,), dtype=f64),
            scale=jr.choice(k7, scales, p=probs),
            jj=jr.randint(k8, (), 0, d), eps_ss=jr.normal(k3, dtype=f64),
            a_ix=a, b_ix=(a + 1 + jr.randint(kb, (), 0, H - 1)) % H,
            g=jr.uniform(kg), logu=jnp.log(jr.uniform(k4, dtype=f64)))

    per_chain = jax.jit(jax.vmap(lambda key: jax.vmap(step)(
        jr.split(key, nsteps))))(keys)
    return RedNoise(**{n: torch.as_tensor(np.swapaxes(np.asarray(v), 0, 1))
                       for n, v in per_chain.items()})


@pytest.mark.parametrize("name", ["R1", "R3"])
@pytest.mark.parametrize("with_hist", [True, False])
def test_red_mh_block_matches_jax(name, with_hist, monkeypatch):
    """20 steps of ``red_mh_block`` per chain with the JAX-drawn noise
    fed to the port's core: the accept sequence (steps that moved the
    state; the JAX scan made to record its carry) is identical and the
    final state agrees to 1e-12."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = models(name)
    C, H, S = 3, 8, 20
    d = len(cmt.idx.red)
    rng = np.random.default_rng(5)
    x = hyper_state(cmt, C, seed=4)[::-1].copy()    # no corner start
    b = rng.normal(size=(C, cmt.P, cmt.Bmax)) * 1e-7
    A = rng.normal(size=(C, d, d)) * 0.1
    U, Sv, _ = np.linalg.svd(A @ A.transpose(0, 2, 1) + 0.01 * np.eye(d))
    hist = x[:, None, cmt.idx.red] + 0.3 * rng.normal(size=(C, H, d))
    keys = jr.split(jr.key(7), C)
    paths = []
    scan = jax.lax.scan

    def recording_scan(f, carry, xs):
        def body(c, k):
            c, _ = f(c, k)
            return c, c[0]

        carry, path = scan(body, carry, xs)
        paths.append(np.asarray(path))
        return carry, None

    monkeypatch.setattr(jax.lax, "scan", recording_scan)
    xj = np.stack([np.asarray(jb.red_mh_block(
        cmj, jnp.asarray(x[c]), jnp.asarray(b[c]), keys[c],
        jnp.asarray(U[c]), jnp.asarray(Sv[c]), S,
        hist=jnp.asarray(hist[c]) if with_hist else None))
        for c in range(C)])
    monkeypatch.undo()
    noise = jax_red_noise(cmj, keys, S, H)
    if not with_hist:
        noise = noise._replace(a_ix=None, b_ix=None, g=None)
    ht = t64(hist) if with_hist else None
    path = [t64(x)]
    for s in range(S):
        step = blocks.RedNoise(*[None if v is None else v[s:s + 1]
                                 for v in noise])
        path.append(blocks.red_mh_block_core(cmt, path[-1], t64(b), t64(U),
                                             t64(Sv), step, ht))
    moved_t = np.diff(torch.stack(path).numpy(), axis=0).any(-1)
    moved_j = np.diff(np.concatenate([x[None], np.stack(paths, 1)]),
                      axis=0).any(-1)
    assert np.array_equal(moved_t, moved_j)
    assert 0 < moved_t.sum() < moved_t.size
    close(path[-1], xj, 0, atol=1e-12)
    whole = blocks.red_mh_block_core(cmt, t64(x), t64(b), t64(U), t64(Sv),
                                     noise, ht)
    assert torch.equal(whole, path[-1])


def test_red_adaptation_equals_jax(monkeypatch):
    """``cov_red``, ``red_U``, ``red_S`` and the seed ``red_hist`` from
    one MH record (C, steps, d), bitwise: the JAX driver's first sweep
    with its adaptation scan replaced by the record (selected per chain
    by the start state) against ``driver.red_adaptation``."""
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_torch.sampler.driver import red_adaptation
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    p = small_psrs()[0]
    pta = model_general([Pulsar(**dataclasses.asdict(p))],
                        common_components=NB, red_components=NB)
    C, steps = 3, 300
    drv = jb.JaxGibbsDriver(pta, seed=0, nchains=C, red_adapt_iters=steps)
    rind = np.asarray(drv.cm.idx.red)
    rec = np.random.default_rng(6).normal(size=(C, steps, len(rind)))
    rec[:, :, 1] += 0.5 * rec[:, :, 0]

    def from_record(cm, x, key, lnlike, ind, nsteps):
        c = jnp.round(x[ind[0]] + 19.5).astype(int)
        return x, jnp.asarray(rec)[c]

    monkeypatch.setattr(jb, "mh_scan", from_record)
    x0 = np.tile(pta.initial_sample(np.random.default_rng(0)), (C, 1))
    x0[:, rind[0]] = -19.5 + np.arange(C)
    drv._first_sweep(x0)
    cov, U, S, hist = red_adaptation(rec)
    for ours, theirs in ((cov, drv.cov_red), (U, drv.red_U),
                         (S, drv.red_S), (hist, drv.red_hist)):
        theirs = np.asarray(theirs)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


@pytest.mark.parametrize("squeezed", [False, True])
def test_de_history_window_equals_jax(squeezed):
    """``_de_hist_for`` on one chain record for DE periods 0..6: the seed
    before the window exists, then chain rows by iteration, bitwise as
    the JAX method gives them (also for the single-chain layout)."""
    from pulsar_timing_gibbsspec_torch.sampler.driver import (
        DE_DELAY, DE_HIST_LEN, DE_Q, TorchGibbsDriver)
    from pulsar_timing_gibbsspec_tpu.sampler.jax_backend import (
        DE_DELAY as J_DELAY, DE_HIST_LEN as J_H, DE_Q as J_Q,
        JaxGibbsDriver)

    assert (DE_HIST_LEN, DE_Q, DE_DELAY) == (J_H, J_Q, J_DELAY) == (64, 128,
                                                                      256)
    rng = np.random.default_rng(8)
    C = 1 if squeezed else 3
    chain = rng.normal(size=(7 * DE_Q, C, 11))
    if squeezed:
        chain = chain[:, 0]
    me = types.SimpleNamespace(
        red_hist=rng.normal(size=(C, DE_HIST_LEN, 3)),
        cm=types.SimpleNamespace(idx=types.SimpleNamespace(
            red=np.array([2, 5, 9]))))
    for m in range(7):
        ours = TorchGibbsDriver._de_hist_for(me, chain, m)
        theirs = JaxGibbsDriver._de_hist_for(me, chain, m)
        assert ours.shape == (C, DE_HIST_LEN, 3)
        assert np.array_equal(ours, theirs), m
        assert (ours is me.red_hist) == (m * DE_Q < DE_DELAY + DE_HIST_LEN)


FLAGS = [(None, None, None), ("conditional", None, None), ("mh", None, None),
         (None, "mh", None), (None, "kernel", None), (None, "bogus", None),
         (None, None, "mh"), (None, None, "conditional"),
         (None, None, "bogus")]


@functools.lru_cache(maxsize=None)
def flag_model_names(which):
    from pulsar_timing_gibbsspec_torch import model_general

    p = nanograv_psr()
    opts = dict(white_vary=True, common_components=NB, red_components=NB,
                device="cpu")
    kw = {"powerlaw red": dict(common_psd="spectrum"),
          "spectrum red": dict(common_psd="spectrum", red_psd="spectrum"),
          "powerlaw common": dict(red_var=False),
          "no red": dict(common_psd="spectrum", red_var=False)}[which]
    return model_general([p], **opts, **kw).param_names


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("which", ["powerlaw red", "spectrum red",
                                   "powerlaw common", "no red"])
def test_sampling_flags_match_jax(which, flags):
    """``validate_sampling_flags``: the port raises what the JAX function
    raises (type and message), or nothing, on each model; the facade
    honours the flags the same way and refuses kernel ECORR."""
    from pulsar_timing_gibbsspec_torch.sampler.blocks import \
        validate_sampling_flags as ours
    from pulsar_timing_gibbsspec_tpu.sampler.blocks import \
        validate_sampling_flags as theirs

    model = types.SimpleNamespace(param_names=flag_model_names(which))
    got = want = None
    try:
        theirs(model, *flags)
    except Exception as e:          # noqa: BLE001 - compared below
        want = (type(e), str(e))
    try:
        ours(model, *flags)
    except Exception as e:          # noqa: BLE001
        got = (type(e), str(e))
    assert got == want


def test_facade_takes_the_flags():
    """The facades pass the flags through: ``redsample='conditional'``
    on a powerlaw red model raises, ``'mh'`` is honoured, kernel ECORR
    is refused on a model compiled with basis ECORR."""
    from pulsar_timing_gibbsspec_torch import PulsarBlockGibbs

    cm = models("R1")[1]
    with pytest.raises(NotImplementedError, match="redsample='conditional'"):
        PulsarBlockGibbs(cm, device="cpu", redsample="conditional")
    g = PulsarBlockGibbs(cm, device="cpu", redsample="mh",
                         hypersample="conditional", ecorrsample="mh")
    assert g.driver.do_red_mh
    with pytest.raises(ValueError, match="kernel_ecorr=True"):
        PulsarBlockGibbs(cm, device="cpu", ecorrsample="kernel")


@pytest.mark.parametrize("kind", ["uniform", "normal", "linexp", "invgamma"])
def test_initial_draws_follow_the_prior(kind):
    """``initial_sample`` draws each prior kind from its prior (KS test,
    p > 1e-3, 4000 chains at a fixed seed): uniform and LinearExp
    amplitudes as ``model_general(upper_limit=True)`` builds them,
    normal and InvGamma on coordinates set to those kinds."""
    from scipy import stats

    from pulsar_timing_gibbsspec_torch import PulsarBlockGibbs, model_general

    cm = model_general([small_psrs()[0]], white_vary=True,
                       common_components=NB, red_components=NB,
                       upper_limit=True, device="cpu")
    j = next(int(i) for i in cm.idx.red
             if "log10_A" in cm.param_names[i])      # LinearExp
    assert int(cm.pkind[j]) == 2
    a, b_ = float(cm.pa[j]), float(cm.pb[j])
    if kind == "uniform":
        j = int(cm.idx.white[0])
        a, b_ = float(cm.pa[j]), float(cm.pb[j])
        cdf = stats.uniform(a, b_ - a).cdf
    elif kind == "linexp":
        def cdf(v):
            return (10.0 ** v - 10.0 ** a) / (10.0 ** b_ - 10.0 ** a)
    else:
        a, b_ = (0.5, 2.0) if kind == "normal" else (1.5, 2.0)
        cm.pkind[j] = 1 if kind == "normal" else 3
        cm.pa[j], cm.pb[j] = a, b_
        cdf = (stats.norm(a, b_).cdf if kind == "normal"
               else stats.invgamma(a, scale=b_).cdf)
    g = PulsarBlockGibbs(cm, nchains=4000, device="cpu")
    x = g.initial_sample(torch.Generator().manual_seed(11)).numpy()
    assert np.isfinite(x).all() and np.isfinite(cm.lnprior(t64(x))).all()
    assert stats.kstest(x[:, j], cdf).pvalue > 1e-3


def test_linexp_lnprior_matches_jax():
    """The LinearExp amplitude prior's density equals the JAX model's at
    16 states, to one float32 ULP per parameter as ``lnprior`` above."""
    import jax

    from pulsar_timing_gibbsspec_torch import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    cmj = compile_pta(jax_model("R3", upper_limit=True))
    cmt = model_general([nanograv_psr()], device="cpu", upper_limit=True,
                        **CASES["R3"])
    assert sorted(set(cmt.pkind.tolist())) == [0, 2]
    x = hyper_state(cmt, 16, seed=9)[1:]
    ref = np.asarray(jax.vmap(cmj.lnprior)(x))
    got = cmt.lnprior(t64(x))
    close(got, ref, 0, atol=cmt.nx * 4 * 2.0 ** -23)
    assert math.isinf(float(cmt.lnprior(t64(x[0] - 100.0))))


def test_r3_posterior_matches_jax(tmp_path_factory):
    """R3 in the whole sampler (common and red powerlaw, no free
    spectrum; JSYN02 without its NANOGrav flag, so without ECORR
    columns): ``PulsarBlockGibbs`` on both sides, 8 chains from one
    start, 5 warmup sweeps, the adaptation, 75 steady sweeps.  The common
    log10_A and gamma and the red hypers: the means over chains of the
    chains' steady medians agree within 5 combined Monte-Carlo standard
    errors; no rho draw, no scale moves."""
    from test_torch_cases import medians_agree, run_both

    p = nanograv_psr()
    p.flags = {}
    _, jchain, tg, tchain, _ = run_both(
        tmp_path_factory, [p], "PulsarBlockGibbs", nchains=8, warmup=5,
        niter=81, white_adapt=120, red_adapt=200, common_components=NB,
        red_components=NB)
    cm = tg.cm
    assert cm.gw_kind == "powerlaw" and len(cm.rho_ix_x) == 0
    assert tg.driver.sweep_blocks(False) == ["white", "red_mh", "b_mh"]
    cols = [int(j) for j in cm.idx.red]
    assert {cm.param_names[j] for j in cols} >= {"gw_crn_log10_A",
                                                 "gw_crn_gamma"}
    medians_agree(jchain, tchain, 6, cols, [cm.param_names[j] for j in cols])
    assert np.isfinite(tchain).all()
