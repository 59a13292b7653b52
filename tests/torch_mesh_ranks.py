"""Rank functions of the port's mesh tests (``test_torch_sharding.py``,
``test_torch_reshard.py``), started by ``parallel.sharding.spawn``.

A spawned rank imports this module to find its function, so it imports
torch, numpy and the port only: never JAX.  Each function takes the rank
first and returns plain numpy / Python values (pickled back to the
parent)."""

import shutil
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(1)

DAY = 86400.0
#: the sampler options of the synthetic single-pulsar runs (the JAX
#: chaos suite's reshard cases: 2 warmup sweeps, chunks of 4)
SYNTH_KW = dict(device="cpu", seed=3, progress=False, warmup_sweeps=2,
                chunk_size=4, nchains=4)
#: the five-pulsar array: white, red and common free spectra
FIVE_KW = dict(device="cpu", seed=5, progress=False, warmup_sweeps=3,
               white_adapt_iters=40, chunk_size=4, nchains=4)


def synth_psr():
    """The port's copy of ``tests/conftest.py::synth_pta``'s pulsar."""
    from pulsar_timing_gibbsspec_torch.data.dataset import Pulsar

    rng = np.random.default_rng(11)
    n = 60
    span = 6.0 * 365.25 * DAY
    toas = np.sort(rng.uniform(0.0, span, n)) + 53000.0 * DAY
    errs = np.full(n, 5e-7)
    res = errs * rng.standard_normal(n)
    t = (toas - toas.mean()) / span
    M = np.column_stack([np.ones(n), t, t * t])
    return Pulsar(
        name="FAKE_CHAOS", toas=toas, toaerrs=errs, residuals=res,
        freqs=np.full(n, 1400.0),
        backend_flags=np.asarray(["sim"] * n, dtype=object),
        Mmat=M, fitpars=["offset", "F0", "F1"],
        flags={"pta": "NANOGrav"}, pos=np.array([1.0, 0.0, 0.0]))


def synth_cm(pad=4):
    """``synth_pta``'s model (one pulsar, a 4-bin common free spectrum,
    fixed white noise) on the port, padded to ``pad`` pulsars."""
    from pulsar_timing_gibbsspec_torch.models.build import model_arrays
    from pulsar_timing_gibbsspec_torch.sampler.compiled import from_arrays

    return from_arrays(model_arrays(
        [synth_psr()], pad_pulsars=pad, red_var=False, white_vary=False,
        common_psd="spectrum", common_components=4), device="cpu")


def five_psrs():
    from pulsar_timing_gibbsspec_torch.data import synthetic_array

    return synthetic_array(npsr=5, seed=2, ntoa_min=40, ntoa_max=70)


def five_cm(pad=6):
    """Five synthetic pulsars under the repository's CRN array model
    (varied white noise, free-spectrum red and common processes, 3 bins
    each), padded to ``pad``."""
    from pulsar_timing_gibbsspec_torch import build_crn_spectrum

    return build_crn_spectrum(five_psrs(), 3, 3, pad_pulsars=pad,
                              device="cpu")


def x0_of(cm, nchains):
    from pulsar_timing_gibbsspec_torch.sampler.gibbs import prior_sample

    return prior_sample(cm, nchains,
                        torch.Generator().manual_seed(0)).numpy()


def _mesh(devices):
    from pulsar_timing_gibbsspec_torch.parallel.sharding import make_mesh

    return make_mesh(devices, device="cpu")


def run_chains(rank, jobs, niter, outdir):
    """Sharded runs of ``jobs``, each ``(model, devices)`` (``model``
    ``"synth"`` or ``"five"``), under ``make_mesh(devices)`` to ``niter``
    sweeps.  Returns per job the chain, the b chain, the collectives of
    one more steady sweep, the mesh's layout, this rank's shard rows
    ``(p0, pn, c0, cn)``, the x it holds after that sweep, and the
    refusal of a mesh twice the world's size."""
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs
    from pulsar_timing_gibbsspec_torch.parallel import sharding

    try:
        sharding.make_mesh(2 * torch.distributed.get_world_size())
    except RuntimeError as exc:
        refusal = str(exc)
    out = []
    for model, devices in jobs:
        cm, kw = ((synth_cm(), SYNTH_KW) if model == "synth"
                  else (five_cm(), FIVE_KW))
        mesh = _mesh(devices)
        g = PTABlockGibbs(cm, mesh=mesh, **kw)
        chain = g.sample(x0_of(cm, kw["nchains"]),
                         outdir=Path(outdir) / f"{model}_{devices}",
                         niter=niter, save_every=4)
        drv = g.driver
        c = drv.carry
        (x, _, _), counts = sharding.collective_report(
            lambda: drv._sweep(c.x, c.b, c.u, False, niter))
        out.append({"chain": chain, "bchain": g.bchain, "counts": counts,
                    "layout": sharding.mesh_layout(mesh),
                    "rows": (drv.cm.p0, drv.cm.pn, drv.c0, drv.Cl),
                    "x": x.numpy(), "blocks": drv.sweep_blocks(False),
                    "refusal": refusal})
    return out


def write_sources(rank, root):
    """Under a world of 4: the 1-d and the 2-d source checkpoints (8
    sweeps), the 4-rank resume of the 1-d one to 16, and a kill between
    the two replaces of a save on the 2-d mesh recovered by
    ``run_supervised`` to 24."""
    from pulsar_timing_gibbsspec_torch import PTABlockGibbs
    from pulsar_timing_gibbsspec_torch.runtime import (faults, integrity,
                                                       run_supervised,
                                                       telemetry)

    root = Path(root)
    cm = synth_cm()
    x0 = x0_of(cm, 4)
    PTABlockGibbs(cm, mesh=_mesh(4), **SYNTH_KW).sample(
        x0, outdir=root / "src4", niter=8, save_every=4)
    PTABlockGibbs(cm, mesh=_mesh((2, 2)), **SYNTH_KW).sample(
        x0, outdir=root / "src2d", niter=8, save_every=4)
    dst = root / "dev4"
    if rank == 0:
        shutil.copytree(root / "src4", dst)
    torch.distributed.barrier()
    kw = {k: v for k, v in SYNTH_KW.items() if k != "nchains"}
    g = integrity.reshard_restore(dst, cm, devices=4, **kw)
    dev4 = g.sample(x0, outdir=dst, niter=16, resume=True, save_every=4)
    telemetry.reset()
    faults.inject("crash", point="chainstore.between_replaces", at_row=16)
    g = PTABlockGibbs(cm, mesh=_mesh((2, 2)), **SYNTH_KW)
    kill, rep = run_supervised(g, x0, root / "kill2d", 24, save_every=4,
                               sleep=lambda s: None)
    faults.clear()
    return {"dev4": dev4, "kill": kill, "retries": rep.retries,
            "failures": [f["kind"] for f in rep.failures],
            "rollbacks": telemetry.get("rollbacks"),
            "layout4": integrity.read_layout(dst)}


def resume_steps(rank, root, steps):
    """Resume copies of the source checkpoints: ``steps`` is a list of
    ``(src, dst, devices, niter, fault_devices)``; ``src`` None resumes
    ``dst`` in place, ``fault_devices`` arms
    ``device_count_change_on_resume`` first.  Returns each step's chain,
    its mesh size and its recorded layout."""
    from pulsar_timing_gibbsspec_torch.runtime import faults, integrity

    root = Path(root)
    cm = synth_cm()
    x0 = x0_of(cm, 4)
    kw = {k: v for k, v in SYNTH_KW.items() if k != "nchains"}
    out = []
    for src, dst, devices, niter, fault in steps:
        if src is not None:
            if rank == 0:
                shutil.copytree(root / src, root / dst)
            torch.distributed.barrier()
        if fault is not None:
            faults.inject("device_count_change_on_resume", devices=fault)
        g = integrity.reshard_restore(root / dst, cm, devices=devices, **kw)
        chain = g.sample(x0, outdir=root / dst, niter=niter, resume=True,
                         save_every=4)
        out.append({"chain": chain,
                    "mesh": None if g.mesh is None else g.mesh.size,
                    "layout": integrity.read_layout(root / dst)})
    try:
        integrity.reshard_restore(root / "src4", cm, devices=1, **kw)
        refusal = None
    except integrity.CheckpointError as exc:
        refusal = str(exc)
    out.append({"refusal": refusal})
    return out
