#!/usr/bin/env python3
"""Where a sharded run first leaves the unsharded one, block by block.

Usage: python3 tools/torch_mesh_divergence_probe.py [--device cuda|cpu]
       [--npsr 45] [--pad 46] [--chains 64] [--sweeps 2]

Runs ``chip_smoke.py`` phase 25's model (the synthetic array of
``--npsr`` pulsars padded to ``--pad``, ``--chains`` chains, 20 warmup
sweeps of which the first ``--sweeps`` are recorded) unsharded and on two
gloo ranks sharing the device (``parallel.sharding.spawn``), recording
the output of every block function of the warmup sweeps (the Laplace
factor, the white MH scan, the red, rho and scale draws, the refresh
b-draw, the Grams and factors under them) as logical arrays, and prints
for each call whether the two runs agree bitwise and their largest
difference.  The first call that differs names the operation whose bits
depend on the layout.  Needs no card with ``--device cpu``.
"""

import argparse
import json
import sys
from pathlib import Path

#: the block functions recorded, in ``sampler.blocks`` and the kernels
WATCH = ("laplace_newton_chol", "parallel_cov_mh_scan",
         "red_conditional_update", "rho_update", "rho_scale_moves",
         "draw_b_refresh", "draw_b_fn", "tnt_d", "tnt_d_seg",
         "tnt_d_seg32")


def _tensors(out):
    import torch

    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def run(rank, device, npsr, pad, chains, sweeps, sharded):
    """One run; returns ``[(name, [arrays])]`` of the watched calls in
    the first ``sweeps`` warmup sweeps (rank 0's logical arrays)."""
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import synthetic_array
    from pulsar_timing_gibbsspec_torch.parallel import sharding
    from pulsar_timing_gibbsspec_torch.sampler import blocks, driver

    dev = torch.device(device)
    cm = ptt.build_crn_spectrum(synthetic_array(npsr=npsr, seed=0), 10, 10,
                                pad_pulsars=pad, device=dev)
    mesh = sharding.make_mesh(2, device=device) if sharded else None
    log, state = [], {"sweep": -1}

    def logical(t, shard):
        import numpy as np

        a = t.detach().cpu().numpy()
        if shard is None:
            return a
        parts = shard.mesh.all_gather_object(a)
        # (chains, pulsars, ...) blocks concatenate on the pulsar axis; a
        # state x takes each slot from the rank owning its pulsar
        p = next((i for i, s in enumerate(a.shape)
                  if s == shard.pn and shard.pn != shard.P), None)
        if p is not None:
            return np.concatenate(parts, axis=p)
        if a.shape[-1] == cm.nx:
            own = shard.owner.cpu().numpy()
            return np.stack(parts)[own, ..., np.arange(cm.nx)].transpose(
                tuple(range(1, a.ndim)) + (0,))
        return parts[0]

    def wrap(mod, name):
        fn = getattr(mod, name)

        def inner(cm_, *args, **kw):
            out = fn(cm_, *args, **kw)
            if state["sweep"] < sweeps:
                log.append((name, [logical(t, cm_.shard)
                                   for t in _tensors(out)]))
            return out

        setattr(mod, name, inner)

    for name in WATCH:
        wrap(blocks, name)
    reseed = driver.TorchGibbsDriver._reseed

    def _reseed(self, t):
        state["sweep"] = t
        reseed(self, t)

    driver.TorchGibbsDriver._reseed = _reseed
    g = ptt.PTABlockGibbs(cm, nchains=chains, device=dev, seed=0,
                          warmup_sweeps=20, progress=False, graphs=False,
                          mesh=mesh)
    x0 = g.initial_sample(torch.Generator(device=dev).manual_seed(0))
    out = Path("build/divergence_probe") / ("mesh" if sharded else "one")
    g.sample(x0, outdir=out, niter=22, save_every=100)
    return log if rank == 0 else None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--npsr", type=int, default=45)
    ap.add_argument("--pad", type=int, default=46)
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--sweeps", type=int, default=2)
    a = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import numpy as np

    from pulsar_timing_gibbsspec_torch.parallel import sharding

    args = (a.device, a.npsr, a.pad, a.chains, a.sweeps)
    one = run(0, *args, False)
    two = sharding.spawn(run, 2, backend="gloo",
                         device="cuda:0" if a.device == "cuda" else "cpu",
                         args=args + (True,))[0]
    first = None
    for i, ((n1, v1), (n2, v2)) in enumerate(zip(one, two)):
        same = all(np.array_equal(p, q, equal_nan=True)
                   for p, q in zip(v1, v2))
        diff = max((float(np.nanmax(np.abs(p.astype(np.float64)
                                            - q.astype(np.float64))))
                    if p.size else 0.0) for p, q in zip(v1, v2)) \
            if v1 else 0.0
        print(json.dumps({"call": i, "block": n1, "bitwise": same,
                          "max_abs_diff": diff}), flush=True)
        if not same and first is None:
            first = (i, n1)
    print(f"calls {len(one)} unsharded, {len(two)} sharded; first "
          f"differing call: {first}", flush=True)


if __name__ == "__main__":
    main()
