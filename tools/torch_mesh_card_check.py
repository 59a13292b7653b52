#!/usr/bin/env python3
"""Phases 25-25c of ``chip_smoke.py`` alone on the card.

Usage: python3 tools/torch_mesh_card_check.py [--seed S] [--outdir DIR]

Builds the kernels, runs phase 4's array unsharded with CUDA graphs to W
+ 1 + 48 rows (phase 25b's reference, as phase 4's first rows), then
:func:`chip_smoke.mesh_paths`: the array padded to 46 pulsars unsharded
and on two gloo ranks sharing the card, the mid-run checkpoint resumed
on one rank, and one NCCL rank on a (1, 1) mesh.  Exits non-zero when a
phase fails.
"""

import argparse
import sys
import time
from pathlib import Path



def main():
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--outdir", default="build/mesh_check")
    args = ap.parse_args()
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import synthetic_array
    from pulsar_timing_gibbsspec_torch.ops.kernels import build

    chip_smoke._RUN_START = time.perf_counter()
    print(f"card: {chip_smoke.card_line()}", flush=True)
    build.library()
    dev = torch.device("cuda")
    psrs = synthetic_array(npsr=45, seed=args.seed)
    cm = ptt.build_crn_spectrum(psrs, nbins=10, red_bins=10, device=dev)
    n = chip_smoke.WARMUP + 1 + chip_smoke.P25_STEADY
    g = ptt.PTABlockGibbs(cm, nchains=chip_smoke.NCHAINS, device=dev,
                          seed=args.seed, warmup_sweeps=chip_smoke.WARMUP,
                          progress=False)
    x0 = g.initial_sample(torch.Generator(device=dev).manual_seed(
        args.seed))
    outdir = Path(args.outdir)
    chain = g.sample(x0, outdir=outdir / "head", niter=n)
    head = (chain.copy(), g.bchain.copy())
    del g
    chip_smoke.elapsed("phase 25b's reference")
    rows = chip_smoke.mesh_paths(args, psrs, head, outdir)
    if rows is None:
        return 1
    for r in rows:
        print(r, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
