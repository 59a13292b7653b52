"""The PyTorch port stands alone: no module of
``pulsar_timing_gibbsspec_torch`` and not ``chip_smoke.py`` imports JAX
or anything of the JAX package (checked on the syntax tree, so imports
inside functions count too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pulsar_timing_gibbsspec_torch"
FORBIDDEN = ("jax", "jaxlib", "pulsar_timing_gibbsspec_tpu")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [pytest.param(f, id=str(f.relative_to(ROOT))) for f in files]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_has_modules():
    assert len(_sources()) > 15


@pytest.mark.parametrize("path", _sources())
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
