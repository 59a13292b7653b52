"""The port's mesh (``pulsar_timing_gibbsspec_torch/parallel``) on gloo
ranks of this host's CPU: ``tests/test_sharding.py``'s cases that are
not about XLA's HLO, against the JAX functions where both packages have
them, and the sharded sweep held against the unsharded one.

On ``synth_pta``'s model padded to 4 (pulsar meshes 1, 2, 4 and the
``(2, 2)`` chain x pulsar mesh) and on five synthetic pulsars under the
CRN array model padded to 6 (pulsar meshes 2, 3 and ``(2, 2)``), a
sharded run's chain and b chain equal the unsharded CPU run's: each rank
draws every noise tensor at the logical shape and keeps its rows, and
each cross-pulsar reduction gathers the per-pulsar terms and reduces
them in the logical order.  ``synth_pta``'s are bitwise; the five-pulsar
model's stay within :data:`FIVE_RTOL` (the CPU's elementwise kernels
round by position, see there).  ``x`` is the same on every rank of a
pulsar group at the end of each sweep (``Mesh.assemble`` raises on a
difference at every recorded row; the tests also compare the ranks' x
after one more sweep).  The collectives of one steady sweep are pinned:
one all-gather for each block that writes per-pulsar slots of x (white,
red), one for the common rho draw and one per frequency of the scale
moves; none on the host.  The rank functions live in
``torch_mesh_ranks.py``, which imports no JAX.
"""

import importlib
import sys
import types

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from pulsar_timing_gibbsspec_torch.parallel import sharding

torch.set_num_threads(2)
NITER = 16


def _duck_mesh(shape):
    """A stand-in for a ``Mesh`` of ``shape`` (rank 0 of it) for the
    functions that read only the grid: no process group is made."""
    axes = ("chain", "pulsar") if len(shape) == 2 else ("pulsar",)
    return types.SimpleNamespace(
        devices=np.arange(int(np.prod(shape))).reshape(shape),
        axis_names=axes, size=int(np.prod(shape)), rank=0,
        device=torch.device("cpu"), chain_index=0, pulsar_index=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The unsharded CPU runs and the sharded ones: worlds of 1, 2, 3 and
    4 ranks, one spawn each."""
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs

    root = tmp_path_factory.mktemp("mesh")
    base = {}
    for name, cm, kw in (("synth", R.synth_cm(), R.SYNTH_KW),
                         ("five", R.five_cm(), R.FIVE_KW)):
        g = PTABlockGibbs(cm, **kw)
        base[name] = (g.sample(R.x0_of(cm, kw["nchains"]),
                               outdir=root / f"base_{name}", niter=NITER,
                               save_every=4), g.bchain)
    jobs = {1: [("synth", 1), ("synth", (1, 1))],
            2: [("synth", 2), ("five", 2)], 3: [("five", 3)],
            4: [("synth", 4), ("synth", (2, 2)), ("five", (2, 2))]}
    out = {}
    for world, js in jobs.items():
        ranks = sharding.spawn(R.run_chains, world,
                               args=(js, NITER, str(root / f"w{world}")))
        for j, job in enumerate(js):
            out[job] = [r[j] for r in ranks]
    return base, out


CASES = [("synth", 1), ("synth", (1, 1)), ("synth", 2), ("synth", 4),
         ("synth", (2, 2)), ("five", 2), ("five", 3), ("five", (2, 2))]


#: the five-pulsar model's class: every recorded value within this
#: relative distance of the unsharded run's.  ATen's CPU elementwise
#: kernels take a vector body and a scalar tail (SLEEF vs libm ``pow`` /
#: ``exp`` / ``log``), so a value's last float32 bit can depend on where
#: it sits in its tensor, and a shard's tensors are shorter: under the
#: (2, 2) mesh ``phi`` of one pulsar moves by an ulp and so does its
#: accepted b proposal (4.5e-13 on values ~1e-6, this host); no accept
#: decision or grid draw moved.  synth_pta's model is bitwise.
FIVE_RTOL = 1e-5


@pytest.mark.parametrize("job", CASES, ids=str)
def test_sharded_chain_equals_unsharded(runs, job):
    base, out = runs
    chain, bchain = base[job[0]]
    for r in out[job]:
        if job[0] == "synth":
            assert np.array_equal(r["chain"], chain)
            assert np.array_equal(r["bchain"], bchain)
        else:
            for got, want in ((r["chain"], chain), (r["bchain"], bchain)):
                assert got.shape == want.shape
                assert np.all(np.abs(got - want)
                              <= FIVE_RTOL * np.abs(want) + 1e-300)


@pytest.mark.parametrize("job", CASES, ids=str)
def test_x_equal_on_every_rank_of_a_pulsar_group(runs, job):
    ranks = runs[1][job]
    shape = ranks[0]["layout"]["axes"]
    n_psr = shape[-1][1]
    for r0 in range(0, len(ranks), n_psr):
        group = ranks[r0:r0 + n_psr]
        for r in group[1:]:
            assert np.array_equal(r["x"], group[0]["x"])


@pytest.mark.parametrize("job", CASES, ids=str)
def test_collectives_per_sweep_pinned(runs, job):
    """One steady sweep: per-pulsar x writers (white, red) one gather
    each, the common rho draw one, the scale moves one per frequency
    (K = 4 for synth, 3 for five), the b-draw none; nothing on the
    host."""
    r = runs[1][job][0]
    K = 4 if job[0] == "synth" else 3
    writers = sum(b in ("white", "red") for b in r["blocks"])
    assert r["blocks"][-1] == "b_mh"
    assert r["counts"]["all_gather"] == writers + 1 + K
    assert r["counts"]["broadcast"] == 0 and r["counts"]["host_gather"] == 0
    assert writers == (0 if job[0] == "synth" else 2)


@pytest.mark.parametrize("job", CASES, ids=str)
def test_shard_rows_tile_the_logical_axes(runs, job):
    ranks = runs[1][job]
    P = 4 if job[0] == "synth" else 6
    shape = ranks[0]["layout"]["axes"]
    n_chain = shape[0][1] if len(shape) == 2 else 1
    n_psr = shape[-1][1]
    got = sorted(r["rows"] for r in ranks)
    want = sorted((j * (P // n_psr), P // n_psr, i * (4 // n_chain),
                   4 // n_chain)
                  for i in range(n_chain) for j in range(n_psr))
    assert got == want


def test_mesh_layout_matches_jax(runs):
    """``mesh_layout`` of the port's 2-d and 1-d meshes is the JAX dict
    for the same shape, ``platform`` aside (the ranks' device type)."""
    from pulsar_timing_gibbsspec_tpu.parallel.sharding import (
        make_mesh as jax_mesh, mesh_layout as jax_layout)

    for job, shape in ((("synth", (2, 2)), (2, 2)), (("synth", 4), 4)):
        port = runs[1][job][0]["layout"]
        jax = jax_layout(jax_mesh(shape))
        assert port["platform"] == "cpu"
        assert ({k: v for k, v in port.items() if k != "platform"}
                == {k: v for k, v in jax.items() if k != "platform"})
    lay = runs[1][("synth", (2, 2))][0]["layout"]
    assert lay["devices"] == 4 and lay["axis"] == "pulsar"
    assert lay["axes"] == [["chain", 2], ["pulsar", 2]]
    assert sharding.mesh_layout(None) is None


def test_mesh_axes_and_submesh_sizes():
    m2 = _duck_mesh((2, 4))
    assert sharding.chain_submesh_size(m2) == 2
    assert sharding.pulsar_submesh_size(m2) == 4
    m1 = _duck_mesh((8,))
    assert sharding.chain_submesh_size(m1) == 1
    assert sharding.pulsar_submesh_size(m1) == 8
    assert sharding.chain_submesh_size(None) == 1
    assert sharding.chain_slice(m2, 1, 2).tolist() == [[4, 5, 6, 7]]
    assert [s.shape for s in sharding.carve_chain_slices(m2, [1, 1])] == \
        [(1, 4), (1, 4)]
    with pytest.raises(ValueError, match="outside the mesh's chain axis"):
        sharding.chain_slice(m2, 1, 3)
    with pytest.raises(ValueError, match="needs a 2-d"):
        sharding.chain_slice(m1, 0, 1)


def test_make_mesh_refusals():
    """Without a default group make_mesh says how to start one; a bad
    2-d shape raises the JAX package's ValueError."""
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        sharding.make_mesh(2)
    for bad in ((2, 4, 1), (0, 4)):
        with pytest.raises(ValueError, match="n_chain_devs"):
            sharding.make_mesh(bad)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_make_mesh_refuses_a_truncated_mesh(runs, world):
    """In a world of n ranks, make_mesh(2 n) raises (the JAX package's
    refusal to build a truncated mesh)."""
    job = next(j for j, r in runs[1].items() if len(r) == world)
    msg = runs[1][job][0]["refusal"]
    assert "refusing to build a truncated mesh" in msg
    assert f"the world has {world} rank(s)" in msg


def test_validate_chains_matches_jax():
    from pulsar_timing_gibbsspec_tpu.parallel.sharding import (
        make_mesh as jax_mesh, validate_chains as jax_validate)

    sharding.validate_chains(_duck_mesh((2, 4)), 4)
    sharding.validate_chains(_duck_mesh((8,)), 3)     # no chain axis
    with pytest.raises(ValueError) as port:
        sharding.validate_chains(_duck_mesh((2, 4)), 3)
    with pytest.raises(ValueError) as jax:
        jax_validate(jax_mesh((2, 4)), 3)
    assert str(port.value) == str(jax.value)
    assert "multiple of 2" in str(port.value)


def test_shard_compiled_pad_suggestion_matches_jax():
    """An unpadded five-pulsar model does not divide a pulsar axis of 4:
    the port raises the JAX package's words; padded to 8 it shards."""
    from test_torch_cases import jax_compiled
    from pulsar_timing_gibbsspec_tpu.parallel.sharding import (
        make_mesh as jax_mesh, shard_compiled as jax_shard)

    from pulsar_timing_gibbsspec_torch import build_crn_spectrum

    psrs = R.five_psrs()
    cm = build_crn_spectrum(psrs, 3, 3, device="cpu")
    with pytest.raises(ValueError) as port:
        sharding.shard_compiled(cm, _duck_mesh((2, 4)))
    with pytest.raises(ValueError) as jax:
        jax_shard(jax_compiled(psrs, 3, 3), jax_mesh((2, 4)))
    assert str(port.value) == str(jax.value)
    assert "pulsar submesh (4 of 8" in str(port.value)
    assert "pad_pulsars=8" in str(port.value)
    cm8 = build_crn_spectrum(psrs, 3, 3, pad_pulsars=8, device="cpu")
    sh = sharding.shard_compiled(cm8, _duck_mesh((2, 4)))
    assert (sh.P, sh.P_real, sh.p0, sh.pn) == (8, 5, 0, 2)
    assert tuple(sh.T.shape[:1]) == (2,) and sh.shard.P == 8
    # the x slots of pulsars 0-1 belong to pulsar-group rank 0, 2-3 to 1
    own = sh.shard.owner.numpy()
    for p in range(5):
        assert (own[cm8.white_par_ix[p][cm8.white_par_ix[p] < cm8.nx]]
                == p // 2).all()


def test_shard_carry_keeps_chain_leaves():
    mesh = _duck_mesh((2, 4))
    mesh.chain_index = 1
    C = 4
    tree = {"x": np.arange(C * 7).reshape(C, 7),
            "b": torch.zeros((C, 3, 5)), "scalar": 1.0,
            "not_chain": np.zeros((3, C))}
    placed = sharding.shard_carry(mesh, tree, C)
    assert np.array_equal(placed["x"], tree["x"][2:4])
    assert tuple(placed["b"].shape) == (2, 3, 5)
    assert placed["not_chain"] is tree["not_chain"]
    assert placed["scalar"] == 1.0
    # a chain-less mesh (or none) is a no-op
    assert sharding.shard_carry(_duck_mesh((4,)), tree, C) is tree
    assert sharding.shard_carry(None, tree, C) is tree


def test_parallel_imports_torch_and_numpy_only():
    """The package's third-party imports are torch and numpy (the rest is
    the standard library and the port)."""
    import ast
    from pathlib import Path

    root = Path(sharding.__file__).parent
    std = set(sys.stdlib_module_names)
    for path in root.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                top = n.split(".")[0]
                assert top in std or top in ("torch", "numpy"), (path, n)
    assert importlib.import_module("pulsar_timing_gibbsspec_torch.parallel")
