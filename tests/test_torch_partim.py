"""README's Quick start from par/tim on the port: the par/tim readers,
the design matrix and the loaders against the JAX package's, on par/tim
files these tests write.

Two pairs: a tempo2-style one (ecliptic coordinates in degrees, D
exponents, a comment line, an ``INCLUDE``d second tim file, unsorted
TOAs, ``-be`` flags only) and a NANOGrav-style one (sexagesimal RAJ/DECJ,
DMX windows, FD terms, flag- and MJD-form JUMPs with and without fit
flags and trailing uncertainties, a DD binary with M2/SINI, ``-f``/``-fe``
/``-be``/``-pta`` flags).  Every array must be equal, bitwise: the port
keeps copies of the same NumPy code.  The errors (injection at
``Tspan = 0``, a degenerate par) must match in type and message.
"""

import dataclasses

import numpy as np
import pytest

from pulsar_timing_gibbsspec_torch import data as tdata

INJECT = dict(log10_A=np.log10(2e-15), gamma=13 / 3, nmodes=8)


def _write_tempo2(d, name="J0030+0451", ntoa=60, seed=5, single_mjd=None):
    """A tempo2-style pair: ecliptic position, D exponents, a second tim
    file pulled in by ``INCLUDE``, TOAs out of time order."""
    par = d / f"{name}.par"
    par.write_text("\n".join([
        "# tempo2 par file",
        f"PSRJ {name}",
        "ELONG 8.91033  1 1.0D-07",
        "ELAT 1.44561 1",
        "PMELONG -5.5 1",
        "F0 205.53069608827D0 1 2.0d-13",
        "F1 -4.2976D-16 1",
        "F2 1.1D-27 1",
        "PEPOCH 55000",
        "DM 4.33 1",
        "DM1 1.0D-4 1",
        "PX 3.1 1",
        "EPHEM DE436",
        "CLK TT(BIPM2017)",
        "UNITS TDB",
        "TRES 1.2",
    ]) + "\n")
    rng = np.random.default_rng(seed)
    mjds = rng.uniform(54000.0, 57000.0, ntoa)
    if single_mjd is not None:
        mjds[:] = single_mjd
    freqs = rng.choice([430.0, 1410.0, 2380.0], ntoa)
    lines = ["FORMAT 1", "C a comment line", "MODE 1"]
    half = ntoa // 2
    for i in range(half):
        lines.append(f"t{i} {freqs[i]:.4f} {mjds[i]:.13f} "
                     f"{rng.uniform(0.5, 3.0):.4f} ao -be ASP")
    lines.append(f"INCLUDE {name}_b.tim")
    (d / f"{name}.tim").write_text("\n".join(lines) + "\n")
    more = ["FORMAT 1"]
    for i in range(half, ntoa):
        more.append(f"t{i} {freqs[i]:.4f} {mjds[i]:.13f} "
                    f"{rng.uniform(0.5, 3.0):.4f} gbt -be GASP -x -1.5")
    (d / f"{name}_b.tim").write_text("\n".join(more) + "\n")
    return par, d / f"{name}.tim"


def _write_nanograv(d, name="J1909-3744", ntoa=120, seed=3):
    """A NANOGrav-style pair: DMX windows (one unfitted), FD terms,
    flag- and MJD-form JUMPs (fitted with trailing uncertainties,
    unfitted, and one whose offset is literally "1"), a DD binary with
    M2/SINI, dual-band sub-banded TOAs with ``-f/-fe/-be/-pta`` flags."""
    par = d / f"{name}.par"
    par.write_text("\n".join([
        f"PSRJ           {name}",
        "RAJ            19:09:47.4335737 1 2e-07",
        "DECJ           -37:44:14.51561 1 9e-06",
        "PMRA           -9.512 1 0.002",
        "PMDEC          -35.78 1 0.006",
        "PX             0.86 1 0.02",
        "F0             339.31568732810D0 1 1.1D-14",
        "F1             -1.6148D-15 1 1.1D-21",
        "PEPOCH         53700",
        "DM             10.3932",
        "DMX_0001       1.2e-3 1 1e-4",
        "DMXR1_0001     53000.0",
        "DMXR2_0001     53090.0",
        "DMX_0002       -0.8e-3 1 1e-4",
        "DMXR1_0002     53090.0",
        "DMXR2_0002     53180.0",
        "DMX_0003       0.1e-3 0 1e-4",
        "DMXR1_0003     53180.0",
        "DMXR2_0003     53270.0",
        "FD1            1.0e-5 1",
        "FD2            -2.0e-6 1",
        "BINARY         DD",
        "PB             1.533449474406 1 1e-12",
        "T0             53113.95",
        "A1             1.89799 1 1e-07",
        "OM             180.1 1 0.01",
        "ECC            1.1D-07 1 1D-08",
        "M2             0.2067 1 0.002",
        "SINI           0.9980 1 0.0001",
        "JUMP -be GUPPI 2.2e-6 0",
        "JUMP -fe Rcvr_800 6.4e-6 1 1.2e-7",
        "JUMP MJD 53100 53150 1.1e-6 1",
        "JUMP -fe L-wide 1",
    ]) + "\n")
    rng = np.random.default_rng(seed)
    mjds = np.sort(rng.uniform(53000, 53300, ntoa))
    lines = ["FORMAT 1"]
    for i, m in enumerate(mjds):
        lo = i % 2 == 0
        freq = rng.uniform(1100.0, 1800.0) if lo else rng.uniform(700.0, 900.0)
        fe = "L-wide" if lo else "Rcvr_800"
        be = "PUPPI" if (int(m / 30.0) % 2 == 0) else "GUPPI"
        lines.append(f"toa{i} {freq:.3f} {m:.12f} {rng.uniform(0.3, 2):.3f} "
                     f"ao -fe {fe} -be {be} -f {fe}_{be} -pta NANOGrav")
    (d / f"{name}.tim").write_text("\n".join(lines) + "\n")
    return par, d / f"{name}.tim"


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("partim")
    return {"tempo2": _write_tempo2(d), "nanograv": _write_nanograv(d)}


def _same(a, b, where):
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        assert a.shape == b.shape and np.array_equal(a, b), where
    else:
        assert a == b, where


def _same_pulsar(p, q):
    for f in dataclasses.fields(q):
        a, b = getattr(p, f.name), getattr(q, f.name)
        if f.name == "flags":
            assert a.keys() == b.keys() and all(a[k] == b[k] for k in a)
        else:
            _same(a, b, f.name)


@pytest.mark.parametrize("which", ["tempo2", "nanograv"])
def test_parse_par_and_tim_match_jax(pairs, which):
    """``parse_par`` (values, fit flags, raw fields, JUMP lines) and
    ``parse_tim`` (sorted MJDs as float64 days, seconds, MHz, flags,
    sites) equal the JAX package's."""
    from pulsar_timing_gibbsspec_tpu.data import partim as jpt

    par, tim = pairs[which]
    a, b = tdata.parse_par(par), jpt.parse_par(par)
    for f in dataclasses.fields(b):
        _same(getattr(a, f.name), getattr(b, f.name), f.name)
    assert a.fitted and (which == "tempo2") == ("ELONG" in a.values)
    ta, tb = tdata.parse_tim(tim), jpt.parse_tim(tim)
    for f in dataclasses.fields(tb):
        _same(getattr(ta, f.name), getattr(tb, f.name), f.name)
    assert np.all(np.diff(ta.mjds) >= 0) and ta.mjds.dtype == np.float64
    assert len(ta.mjds) == (60 if which == "tempo2" else 120)


def test_number_tokens_match_jax():
    from pulsar_timing_gibbsspec_torch.data import partim as tpt
    from pulsar_timing_gibbsspec_tpu.data import partim as jpt

    for tok in ("1.5D-3", "-2d4", "7", ".5", "1e", "abc", "-x", "3.", "-0"):
        assert tpt._to_float(tok) == jpt._to_float(tok)
        assert tpt._is_number(tok) == jpt._is_number(tok)
    for tok, hours in (("17:13:49.5", True), ("-07:47:37.5", False),
                       ("-00:30", False), ("1.25", True)):
        assert tpt._sexagesimal_to_rad(tok, hours) == \
            jpt._sexagesimal_to_rad(tok, hours)


@pytest.mark.parametrize("which", ["tempo2", "nanograv"])
def test_design_matrix_matches_jax(pairs, which):
    """The design matrix and its labels equal the JAX function's, and
    the NANOGrav pair has the DMX, FD, JUMP and binary columns."""
    from pulsar_timing_gibbsspec_torch.data.design import _degenerate_keep
    from pulsar_timing_gibbsspec_tpu.data import design as jd
    from pulsar_timing_gibbsspec_tpu.data import partim as jpt

    par, tim = pairs[which]
    M, lab = tdata.design_matrix(tdata.parse_par(par), tdata.parse_tim(tim),
                                 return_labels=True)
    Mj, labj = jd.design_matrix(jpt.parse_par(par), jpt.parse_tim(tim),
                                return_labels=True)
    _same(M, Mj, "M")
    assert lab == labj
    assert np.array_equal(tdata.design_matrix(
        tdata.parse_par(par), tdata.parse_tim(tim)), M)
    if which == "nanograv":
        for want in ("DMX_0001", "DMX_0002", "FD1", "FD2", "JUMP1", "JUMP2",
                     "ORB_S4", "PM_SIN", "PX_COS"):
            assert want in lab, want
        assert "DMX_0003" not in lab and "JUMP3" not in lab
    dup = np.column_stack([M, M[:, 1]])
    assert _degenerate_keep(dup) == jd._degenerate_keep(dup)
    assert len(_degenerate_keep(dup)) == M.shape[1]


@pytest.mark.parametrize("inject", [None, INJECT],
                         ids=["observed", "injected"])
@pytest.mark.parametrize("which", ["tempo2", "nanograv"])
def test_load_pulsar_matches_jax(pairs, which, inject):
    """Every field of the loaded pulsar equals the JAX package's, with
    and without the injection; the backend labels follow ``-f``, then
    ``-be``; the position is a unit vector (ecliptic rotated to the
    equatorial frame)."""
    from pulsar_timing_gibbsspec_tpu.data import load_pulsar as jload

    par, tim = pairs[which]
    p = tdata.load_pulsar(par, tim, inject=inject)
    _same_pulsar(p, jload(par, tim, inject=inject))
    assert abs(np.linalg.norm(p.pos) - 1.0) < 1e-12
    if inject is None:
        assert not p.residuals.any()
    else:
        assert np.isfinite(p.residuals).all() and p.residuals.std() > 0
    if which == "nanograv":
        assert p.backends() == ["L-wide_GUPPI", "L-wide_PUPPI",
                                "Rcvr_800_GUPPI", "Rcvr_800_PUPPI"]
        assert p.flags == {"pta": "NANOGrav"}
    else:
        assert p.backends() == ["ASP", "GASP"] and p.flags == {"pta": ""}


def test_load_directory_matches_jax(tmp_path):
    """Every ``.par`` with a ``.tim`` beside it, sorted by name; a par
    without its tim is skipped; ``names`` filters; with an injection."""
    from pulsar_timing_gibbsspec_tpu.data import load_directory as jdir

    _write_nanograv(tmp_path)
    _write_tempo2(tmp_path)
    _write_tempo2(tmp_path, name="J2145-0750", ntoa=40, seed=9)
    (tmp_path / "J0000+0000.par").write_text("PSRJ J0000+0000\nF0 1 1\n")
    for kw in (dict(), dict(inject=INJECT), dict(names=["J2145-0750"])):
        ours, theirs = tdata.load_directory(tmp_path, **kw), jdir(tmp_path,
                                                                  **kw)
        assert [p.name for p in ours] == [p.name for p in theirs]
        for p, q in zip(ours, theirs):
            _same_pulsar(p, q)
    assert [p.name for p in tdata.load_directory(tmp_path)] == [
        "J0030+0451", "J1909-3744", "J2145-0750"]


def test_errors_match_jax(tmp_path):
    """An injection over a zero span (every TOA at one epoch) raises the
    JAX package's ValueError; a par without a position gives the zero
    vector on both sides."""
    from pulsar_timing_gibbsspec_tpu.data import load_pulsar as jload

    par, tim = _write_tempo2(tmp_path, name="J1111+1111", ntoa=6,
                             single_mjd=55000.0)
    errs = []
    for load in (tdata.load_pulsar, jload):
        with pytest.raises(ValueError) as e:
            load(par, tim, inject=INJECT)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "Tspan=0.0" in errs[0]
    nopos = tmp_path / "J2222+2222.par"
    nopos.write_text("PSRJ J2222+2222\nF0 100.0 1\nF1 -1e-15 1\n")
    p, q = tdata.load_pulsar(nopos, tim), jload(nopos, tim)
    assert np.array_equal(p.pos, np.zeros(3)) and np.array_equal(q.pos,
                                                                  p.pos)


def test_quickstart_partim_has_the_snapshot_structure(tmp_path):
    """``chip_smoke.py`` phase 13's par/tim pair, written from the
    J1713+0747 snapshot, loads to the snapshot's TOAs, backends and
    105 timing columns (their labels the snapshot's ``fitpars``), and
    its kernel-ECORR Quick-start model has Bmax = 105 + 60 = 165 and 508
    ECORR epochs in N, equal to the JAX package's."""
    import chip_smoke
    from pulsar_timing_gibbsspec_torch.models.build import model_arrays
    from pulsar_timing_gibbsspec_tpu.data import load_pulsar as jload
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta
    from test_torch_cases import jax_fields, same_field

    par, tim = chip_smoke.write_quickstart_partim(tmp_path)
    snap = tdata.load_enterprise_snapshot(chip_smoke.SNAPSHOT)
    p = tdata.load_pulsar(par, tim, inject=chip_smoke.QS_INJECT)
    q = jload(par, tim, inject=chip_smoke.QS_INJECT)
    _same_pulsar(p, q)
    _, lab = tdata.design_matrix(tdata.parse_par(par), tdata.parse_tim(tim),
                                 return_labels=True)
    assert lab == list(snap.fitpars) and p.Mmat.shape == (720, 105)
    assert p.backends() == snap.backends()
    assert np.abs(p.toas - snap.toas).max() <= 1e-3
    opts = dict(red_var=False, white_vary=True, common_psd="spectrum",
                common_components=30)
    got = model_arrays([p], kernel_ecorr=True, **opts)
    ref = jax_fields(compile_pta(model_general([q], **opts),
                                 kernel_ecorr=True))
    for key in ("T", "y", "ke_eid", "ke_par_ix", "const_pool", "Bmax"):
        same_field(ref[key], got[key], key)
    assert (got["Bmax"], got["ke_par_ix"].shape[1]) == (165, 508)
