"""The rest of ``model_general``'s noise model, piece by piece: the port
against the JAX package on the CPU, on the same numpy inputs.

Checked:

- the arrays of the port's ``model_arrays`` equal ``jax_fields(
  compile_pta(model_general(...)))`` field by field (constant pool,
  ``efac_ix``/``equad_ix``/``gequad_ix``, ``phi_base``, components,
  ``gp_mask``, ``gw_hyp_ix``, ``red_hyp_ix``, ``T`` ...) and the
  parameter names are the JAX model's, for fixed white noise from a
  seeded noise dictionary (with and without ECORR, with missing keys),
  ``gequad`` (sampled and fixed), fixed common hypers, each powerlaw-
  family common shape, custom common bounds, ``red_breakflat``, the
  chromatic GPs (with ``upper_limit_dm``), ``dm_annual``,
  ``bayesephem``, the array and single-pulsar models of
  ``chip_smoke.py`` phases 11 and 12 and the Hellings-Downs array with
  fixed white noise and ``dm_var``; the flat b columns' names against
  the JAX facade's;
- each ``_lnphi_*`` against the JAX function at 16 seeded hyper draws
  (float64 hypers to rel 1e-12, float32 hypers to rel 2e-6);
- at 16 seeded states of four models (float64): ``phi``,
  ``phi_hyper_split``'s parts, ``red_phi``, ``gw_phi`` and
  ``lnlike_hyper_fn`` to rel 1e-12, float32 ``phi`` to 2e-6, ``lnprior``
  to one float32 ULP per parameter, ``lnlike_fullmarg_fn`` to rel 1e-9,
  the classes of ``tests/test_torch_red.py``;
- ``red_mh_block_core`` over 20 steps of JAX-drawn noise with the DM and
  scattering hypers in ``idx.red`` (accept sequence identical, final
  state to 1e-12);
- what the JAX function refuses, the port refuses with its type and
  message; several common processes raise ``NotImplementedError``;
- ``validate_sampling_flags`` raises what the JAX function raises on
  these models.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_cases import (close, jax_fields, nanograv_psr, same_field,
                              small_psrs, snapshot_psrs, t64)
from test_torch_red import FLAGS, hyper_state, jax_red_noise

from pulsar_timing_gibbsspec_torch.data import synthetic_noisedict

torch.set_num_threads(2)

NB = 4
BINS = dict(common_components=NB, red_components=NB, dm_components=NB)


def nd_small(seed=3, **kw):
    return synthetic_noisedict(small_psrs(), seed, **kw)


def nd_ng(seed=4, **kw):
    return synthetic_noisedict([nanograv_psr()], seed, **kw)


#: (pulsars, model_general options) of each case; "small" is the
#: 3-pulsar array, "ng" JSYN02 flagged NANOGrav (basis ECORR)
CASES = {
    "fixed white": ("small", dict(noisedict=nd_small())),
    "fixed white ECORR": ("ng", dict(noisedict=nd_ng())),
    "fixed white, empty dict": ("ng", dict(noisedict={})),
    "gequad sampled": ("small", dict(white_vary=True, gequad=True)),
    "gequad fixed": ("small", dict(gequad=True,
                                   noisedict=nd_small(5, gequad=True))),
    "gamma_common": ("small", dict(white_vary=True, gamma_common=13 / 3)),
    "fixed common": ("small", dict(white_vary=True, log10_A_common=-14.5,
                                   gamma_common=13 / 3)),
    "turnover": ("small", dict(white_vary=True, common_psd="turnover")),
    "turnover_knee": ("small", dict(white_vary=True,
                                    common_psd="turnover_knee")),
    "broken_powerlaw": ("small", dict(white_vary=True,
                                      common_psd="broken_powerlaw")),
    "common bounds": ("small", dict(white_vary=True, common_psd="spectrum",
                                    common_logmin=-9.0,
                                    common_logmax=-5.0)),
    "red_breakflat": ("small", dict(white_vary=True, red_breakflat=True,
                                    red_breakflat_fq=3e-8)),
    "dm_var": ("small", dict(white_vary=True, dm_var=True)),
    "dm_chrom": ("small", dict(white_vary=True, dm_var=True, dm_chrom=True,
                               upper_limit_dm=True, dm_psd="turnover",
                               dmchrom_idx=4.4)),
    "dm_chrom upper_limit": ("small", dict(
        white_vary=True, dm_chrom=True, dmchrom_psd="broken_powerlaw",
        upper_limit=True)),
    "dm_annual": ("small", dict(white_vary=True, dm_annual=True)),
    "bayesephem": ("small", dict(white_vary=True, bayesephem=True)),
    "phase 11": ("small", dict(tm_svd=True, noisedict=nd_small(),
                               common_psd="spectrum", dm_var=True,
                               dm_annual=True)),
    "phase 12": ("ng", dict(noisedict=nd_ng(), common_psd="turnover",
                            gamma_common=13 / 3, dm_var=True,
                            bayesephem=True)),
    "hd": ("small", dict(tm_svd=True, noisedict=nd_small(),
                         common_psd="spectrum", red_psd="spectrum",
                         dm_var=True, orf="hd")),
}


def case_psrs(which):
    return small_psrs() if which == "small" else [nanograv_psr()]


def jax_pta(psrs, **opts):
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general

    jp = [p if isinstance(p, Pulsar) else Pulsar(**dataclasses.asdict(p))
          for p in psrs]
    return model_general(jp, **opts)


def port_arrays(psrs, **opts):
    """``model_arrays`` under ``model_general``'s defaults."""
    from pulsar_timing_gibbsspec_torch.models.build import model_arrays

    base = dict(common_psd="powerlaw", red_psd="powerlaw", white_vary=False)
    return model_arrays(psrs, **dict(base, **opts))


def assert_same_model(want, got, pta):
    assert list(got["param_names"]) == list(pta.param_names)
    for key, v in want.items():
        if key == "components":
            assert [c["kind"] for c in v] == [d["kind"] for d in got[key]]
            for c, d in zip(v, got[key]):
                for k in c:
                    same_field(c[k], d[k], f"components.{c['kind']}.{k}")
        elif key in ("dtype", "cdtype"):
            assert np.dtype(v) == np.dtype(got[key])
        else:
            same_field(v, got[key], key)


@pytest.mark.parametrize("name", sorted(CASES))
def test_model_equals_compile_pta(name):
    """The port's arrays equal ``compile_pta``'s field by field; the
    constants sit in the pool in the JAX order; the flat b names are
    the JAX facade's."""
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import PTABlockGibbs

    which, opts = CASES[name]
    psrs = case_psrs(which)
    pta = jax_pta(psrs, **BINS, **opts)
    got = port_arrays(psrs, **BINS, **opts)
    assert_same_model(jax_fields(compile_pta(pta)), got, pta)
    jg = PTABlockGibbs.__new__(PTABlockGibbs)
    jg.pta, jg.ecorrsample = pta, None
    assert list(got["b_names"]) == jg.b_param_names
    if not opts.get("white_vary"):
        assert not any(k in n for n in got["param_names"]
                       for k in ("efac", "equad", "ecorr"))


def test_phase12_model_on_the_snapshot():
    """``chip_smoke.py`` phase 12's model on the J1713+0747 snapshot
    (30 bins; fixed EFAC/EQUAD/ECORR on 508 columns, a turnover common
    process with gamma fixed, red and DM powerlaws, BayesEphem): equal
    to ``compile_pta``'s, Bmax 744, five sampled hypers."""
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    jp, tp = snapshot_psrs()
    opts = dict(noisedict=synthetic_noisedict([tp], 7),
                common_psd="turnover", gamma_common=13 / 3,
                common_components=30, dm_var=True, dm_components=30,
                bayesephem=True)
    pta = jax_pta([jp], **opts)
    got = port_arrays([tp], **opts)
    assert_same_model(jax_fields(compile_pta(pta)), got, pta)
    assert (got["Bmax"], got["nx"], got["ec_cols"].shape[1]) == (744, 5,
                                                                   508)
    assert got["ecorr_nper"].tolist() == [0]
    assert got["gw_hyp_ix"].shape == (1, 4)


@pytest.mark.parametrize("kind", ["powerlaw", "turnover", "turnover_knee",
                                  "broken_powerlaw", "powerlaw_breakflat"])
@pytest.mark.parametrize("hdt", ["float64", "float32"])
def test_lnphi_matches_jax(kind, hdt):
    """Each log-PSD at 16 seeded hyper draws on a 4-pulsar, 6-column
    grid of float32 frequencies and widths: rel 1e-12 with float64
    hypers, 2e-6 with float32 ones."""
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_torch.models.build import (
        PSD_HYPERS, PSD_SHAPE_DEFAULTS)
    from pulsar_timing_gibbsspec_torch.sampler import compiled as tc
    from pulsar_timing_gibbsspec_tpu.sampler import compiled as jc

    rng = np.random.default_rng(11)
    f = (np.arange(1, 7)[None, :] / rng.uniform(3e8, 5e8, (4, 1))).astype(
        np.float32)
    df = (f[:, :1] * np.ones((1, 6))).astype(np.float32)
    names = (("log10_A", "gamma", "log10_fb") if kind == "powerlaw_breakflat"
             else PSD_HYPERS[kind])
    hyp = []
    for nm in names:
        if nm == "log10_A":
            v = rng.uniform(-17.0, -12.0, (16, 4, 1))
        elif nm == "gamma":
            v = rng.uniform(0.0, 7.0, (16, 4, 1))
        elif nm == "log10_fb":
            v = rng.uniform(-9.0, -7.5, (16, 4, 1))
        else:
            d = PSD_SHAPE_DEFAULTS[kind][nm]
            v = d + rng.uniform(-0.3, 0.3, (16, 4, 1))
        hyp.append(v.astype(hdt))
    ref = np.asarray(jc._LNPSD_FNS[kind](jnp.asarray(f), jnp.asarray(df),
                                         *map(jnp.asarray, hyp)))
    got = tc._LNPSD_FNS[kind](torch.as_tensor(f), torch.as_tensor(df),
                              *map(torch.as_tensor, hyp))
    assert got.dtype == torch.float64
    close(torch.exp(got), np.exp(ref), 1e-12 if hdt == "float64" else 2e-6)


#: the four models whose functions are held at 16 states
FN_CASES = ("phase 11", "phase 12", "dm_chrom", "turnover_knee")
FN_EXTRA = {"turnover_knee": dict(red_breakflat=True, red_breakflat_fq=3e-8,
                                  gequad=True, dm_chrom=True)}


@functools.lru_cache(maxsize=None)
def fn_models(name):
    """``(jax_cm, port_cm)`` of a case, the port's from its own
    ``model_general``."""
    from pulsar_timing_gibbsspec_torch import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    which, opts = CASES[name]
    opts = dict(opts, **FN_EXTRA.get(name, {}))
    psrs = case_psrs(which)
    return (compile_pta(jax_pta(psrs, **BINS, **opts)),
            model_general(psrs, device="cpu", **BINS, **opts))


def noise_state(cm, C, seed):
    """:func:`hyper_state` with every powerlaw-family hyper (DM and
    scattering too) inside its prior and the gequad near -7.5."""
    x = hyper_state(cm, C, seed)
    for j, nm in enumerate(cm.param_names):
        if nm.endswith("_log10_gequad"):
            x[:, j] = -7.5
    return x


@pytest.mark.parametrize("name", FN_CASES)
def test_phi_and_likelihoods_match_jax(name):
    """16 states: phi (float64, float32), phi_hyper_split's parts,
    red_phi, gw_phi, lnprior, lnlike_hyper_fn (with and without phi_fn),
    lnlike_fullmarg_fn (the Gram of each state's white noise from the
    exact widening Gram on both sides) at the classes of the module
    docstring."""
    import jax
    import jax.numpy as jnp

    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = fn_models(name)
    x = noise_state(cmt, 16, seed=1)
    b = np.random.default_rng(3).normal(size=(16, cmt.P, cmt.Bmax)) * 1e-7

    def jax_side(x, b):
        static, dyn = cmj.phi_hyper_split(x)
        TNT, d = jb.tnt_d_x(cmj, x, cmj.ndiag(x))
        return dict(phi=cmj.phi(x), phi32=cmj.phi(x, dtype=jnp.float32),
                    static=static, dyn=dyn(x), red_phi=cmj.red_phi(x),
                    gw_phi=cmj.gw_phi(x), lnprior=cmj.lnprior(x),
                    hyper=jb.lnlike_hyper_fn(cmj, x, b),
                    hyper_dyn=jb.lnlike_hyper_fn(cmj, x, b, phi_fn=dyn),
                    full=jb.lnlike_fullmarg_fn(cmj, x, TNT, d))

    ref = {k: np.asarray(v)
           for k, v in jax.jit(jax.vmap(jax_side))(x, b).items()}
    xt, bt = t64(x), t64(b)
    static, dyn = cmt.phi_hyper_split(xt)
    close(cmt.phi(xt), ref["phi"], 1e-12)
    close(cmt.phi(xt, dtype=torch.float32), ref["phi32"], 2e-6)
    close(static, ref["static"], 1e-12)
    close(dyn(xt), ref["dyn"], 1e-12)
    close(cmt.red_phi(xt), ref["red_phi"], 1e-12)
    close(cmt.gw_phi(xt), ref["gw_phi"], 1e-12)
    close(cmt.lnprior(xt), ref["lnprior"], 0, atol=cmt.nx * 4 * 2.0 ** -23)
    close(blocks.lnlike_hyper_fn(cmt, xt, bt), ref["hyper"], 1e-12)
    close(blocks.lnlike_hyper_fn(cmt, xt, bt, phi_fn=dyn), ref["hyper_dyn"],
          1e-12)
    TNT, d = blocks.tnt_d_x(cmt, xt, cmt.ndiag(xt))
    close(blocks.lnlike_fullmarg_fn(cmt, xt, TNT, d), ref["full"], 1e-9)
    assert torch.isfinite(cmt.phi(xt)).all() and (cmt.phi(xt) > 0).all()


@pytest.mark.parametrize("name", ["phase 11", "dm_chrom"])
def test_red_mh_block_with_dm_hypers_matches_jax(name, monkeypatch):
    """20 steps of ``red_mh_block`` per chain, with the chromatic GPs'
    ``log10_A``/``gamma`` in ``idx.red`` beside the red noise's, the
    JAX-drawn noise fed to the port's core and a DE history: the accept
    sequence is identical and the final state agrees to 1e-12."""
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    from pulsar_timing_gibbsspec_torch.sampler import blocks
    from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb

    cmj, cmt = fn_models(name)
    red_names = [cmt.param_names[j] for j in cmt.idx.red]
    assert any("_dm_gp_" in n for n in red_names)
    assert np.array_equal(np.asarray(cmj.idx.red), cmt.idx.red)
    C, H, S = 3, 8, 20
    d = len(cmt.idx.red)
    rng = np.random.default_rng(5)
    x = noise_state(cmt, C, seed=4)[::-1].copy()
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
        hist=jnp.asarray(hist[c]))) for c in range(C)])
    monkeypatch.undo()
    noise = jax_red_noise(cmj, keys, S, H)
    path = [t64(x)]
    for s in range(S):
        step = blocks.RedNoise(*[None if v is None else v[s:s + 1]
                                 for v in noise])
        path.append(blocks.red_mh_block_core(cmt, path[-1], t64(b), t64(U),
                                             t64(Sv), step, t64(hist)))
    moved_t = np.diff(torch.stack(path).numpy(), axis=0).any(-1)
    moved_j = np.diff(np.concatenate([x[None], np.stack(paths, 1)]),
                      axis=0).any(-1)
    assert np.array_equal(moved_t, moved_j)
    assert 0 < moved_t.sum() < moved_t.size
    close(path[-1], xj, 0, atol=1e-12)


#: options the JAX function refuses too (same type and message)
JAX_REFUSES = [dict(tm_var=True), dict(use_dmdata=True),
               dict(dm_type="dmx"), dict(red_psd="tprocess_adapt"),
               dict(red_breakflat=True),
               dict(red_psd="spectrum", red_breakflat=True,
                    red_breakflat_fq=1e-8),
               dict(red_psd="turnover"), dict(red_psd="broken_powerlaw"),
               dict(common_psd="bogus"), dict(dm_var=True, dm_psd="spectrum"),
               dict(dm_chrom=True, dmchrom_psd="spectrum"),
               dict(orf="hd", common_psd="powerlaw"),
               dict(orf="zero_diag_hd", common_psd="spectrum"),
               dict(bayesephem=True, be_type="DE440"), dict(bogus_option=1),
               dict(red_select="band"), dict(red_select="backend"),
               dict(red_select="band", red_psd="spectrum"),
               dict(red_select="bogus"), dict(select="bogus"),
               dict(logfreq=True, common_psd="spectrum")]
#: options JAX takes and the port refuses, and the port's reason
PORT_LACKS = [(dict(orf="crn,crn", orf_names="crn,crn2",
                    common_psd="spectrum"), "samples only the first"),
              (dict(orf="crn,crn"), "samples only the first")]


def test_refusals_match_jax():
    """What the JAX ``model_general`` + ``compile_pta`` refuses, the
    port refuses with the same exception type and message (the band
    and backend splits of red noise where the pulsars' groups differ, a
    free spectrum on the log grid, an unknown selection); several common
    processes, which the JAX function builds, raise
    ``NotImplementedError`` saying that its compiled model samples only
    the first."""
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

    psrs = small_psrs()
    for opts in JAX_REFUSES:
        want = got = None
        try:
            compile_pta(jax_pta(psrs, **BINS, **opts))
        except Exception as e:          # noqa: BLE001 - compared below
            want = (type(e), str(e))
        try:
            port_arrays(psrs, **BINS, **opts)
        except Exception as e:          # noqa: BLE001
            got = (type(e), str(e))
        assert want is not None and got == want, opts
    for opts, why in PORT_LACKS:
        compile_pta(jax_pta(psrs, **BINS, **opts))
        with pytest.raises(NotImplementedError, match=why):
            port_arrays(psrs, **BINS, **opts)


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("name", ["phase 11", "phase 12", "fixed white"])
def test_sampling_flags_match_jax(name, flags):
    """``validate_sampling_flags`` on the standard noise model (the DM
    hypers beside the red ones, no white or ECORR parameter): the port
    raises what the JAX function raises (type and message), or
    nothing."""
    import types

    from pulsar_timing_gibbsspec_torch.sampler.blocks import \
        validate_sampling_flags as ours
    from pulsar_timing_gibbsspec_tpu.sampler.blocks import \
        validate_sampling_flags as theirs

    which, opts = CASES[name]
    model = types.SimpleNamespace(param_names=port_arrays(
        case_psrs(which), **BINS, **opts)["param_names"])
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
