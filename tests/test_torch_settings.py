"""The port's settings from the environment against the JAX package's
``Settings``.

The JAX module reads ``PTGIBBS_PRECISION``, ``PTGIBBS_COMPUTE`` and
``PTGIBBS_JOINT_MIXED`` when it is imported, so each environment runs in
a child process of its own (four in all), which prints both sides'
readings as JSON.  Class: exact equality of every reading and of every
error message.  In the parent, the port alone: it reads the variables
when asked, and refuses what the JAX package would map to float32
without a word.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pulsar_timing_gibbsspec_torch.config import (Settings, SettingsError,
                                                  current_settings)

ROOT = Path(__file__).resolve().parents[1]

#: the child: the JAX Settings of its environment and the port's, then
#: (under ``CHILD_BAD_SEG``) each bad segment length's error on both sides
CHILD = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
from pulsar_timing_gibbsspec_tpu import config as jc
from pulsar_timing_gibbsspec_torch import config as pc

def port():
    try:
        s = pc.current_settings()
    except pc.SettingsError as e:
        return {"error": str(e)}
    return {"storage": str(s.dtype).split(".")[1],
            "compute": str(s.cdtype).split(".")[1],
            "seg": s.gram_seg_len, "seg_exact": s.gram_seg_len_exact,
            "joint_mixed": s.joint_mixed}

def jax():
    try:
        s = jc.Settings()
    except jc.SettingsError as e:
        return {"error": str(e)}
    return {"storage": s.real_dtype().__name__,
            "compute": s.compute_dtype().__name__,
            "seg": s.gram_seg_len, "seg_exact": s.gram_seg_len_exact,
            "joint_mixed": s.joint_mixed}

out = {"jax": jax(), "port": port(), "bad": []}
if os.environ.get("CHILD_BAD_SEG"):
    for var in ("PTGIBBS_GRAM_SEG", "PTGIBBS_GRAM_SEG_EXACT"):
        for raw in ("0", "-3", "abc", "1.5"):
            os.environ[var] = raw
            out["bad"].append([var, raw, jax(), port()])
            del os.environ[var]
    for kw in ({"gram_seg_len": 0}, {"gram_seg_len_exact": True}):
        row = []
        for S, E in ((jc.Settings, jc.SettingsError),
                     (pc.Settings, pc.SettingsError)):
            try:
                S(**kw)
                row.append(None)
            except E as e:
                row.append(str(e))
        out["bad"].append([kw, row])
print(json.dumps(out))
"""

_VARS = ("PTGIBBS_PRECISION", "PTGIBBS_COMPUTE", "PTGIBBS_GRAM_SEG",
         "PTGIBBS_GRAM_SEG_EXACT", "PTGIBBS_JOINT_MIXED")


def _child(**env):
    full = {k: v for k, v in os.environ.items() if k not in _VARS}
    full.update(env, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", CHILD, str(ROOT)],
                         env=full, capture_output=True, text=True,
                         timeout=300, check=False)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("env,want", [
    ({"CHILD_BAD_SEG": "1"},
     dict(storage="float32", compute="float64", seg=96, seg_exact=96,
          joint_mixed=True)),
    ({"PTGIBBS_PRECISION": "f64", "PTGIBBS_GRAM_SEG": "48",
      "PTGIBBS_GRAM_SEG_EXACT": "200", "PTGIBBS_JOINT_MIXED": "0"},
     dict(storage="float64", compute="float64", seg=48, seg_exact=200,
          joint_mixed=False)),
    ({"PTGIBBS_COMPUTE": "f32"},
     dict(storage="float32", compute="float32", seg=96, seg_exact=96,
          joint_mixed=True)),
], ids=["defaults_and_bad_segments", "f64_storage", "f32_compute"])
def test_environment_matches_jax(env, want):
    out = _child(**env)
    assert out["jax"] == want
    assert out["port"] == want
    for row in out["bad"]:
        if len(row) == 4:       # a bad environment value: same message
            var, raw, j, p = row
            assert "error" in j and j == p, (var, raw, j, p)
            assert var in p["error"]
        else:                   # a bad constructor value: same message
            kw, (j, p) = row
            assert j is not None and j == p, kw
    assert len(out["bad"]) == (10 if "CHILD_BAD_SEG" in env else 0)


def test_precision_typo_refused_where_jax_runs_float32():
    """``PTGIBBS_PRECISION=F64``: the JAX package runs float32 storage
    without a word (its mapping: anything but ``"f64"``); the port
    raises a ``SettingsError`` naming the variable (ROADMAP C.21)."""
    out = _child(PTGIBBS_PRECISION="F64", PTGIBBS_COMPUTE="double")
    assert out["jax"]["storage"] == "float32"
    assert out["jax"]["compute"] == "float32"
    assert "PTGIBBS_PRECISION='F64'" in out["port"]["error"]


def test_port_reads_when_asked(monkeypatch):
    """The port reads the environment at each build, not at import: one
    process sees both precisions; the module's defaults read nothing."""
    from pulsar_timing_gibbsspec_torch.config import settings

    for var in _VARS:
        monkeypatch.delenv(var, raising=False)
    assert current_settings() == Settings() == settings
    monkeypatch.setenv("PTGIBBS_PRECISION", "f64")
    monkeypatch.setenv("PTGIBBS_COMPUTE", "f32")
    s = current_settings()
    # float32 compute is the storage dtype, as in the JAX package
    assert (s.dtype, s.cdtype) == (torch.float64, torch.float64)
    assert settings.dtype == torch.float32
    for var, raw in (("PTGIBBS_PRECISION", "double"),
                     ("PTGIBBS_COMPUTE", "F32"),
                     ("PTGIBBS_PRECISION", " f64")):
        monkeypatch.setenv(var, raw)
        with pytest.raises(SettingsError, match=var):
            current_settings()
        monkeypatch.setenv(var, "f64")
    with pytest.raises(SettingsError, match="settings.precision"):
        Settings(precision="f16")
