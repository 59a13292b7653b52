#!/usr/bin/env python3
"""Phase 4's main path timed at several checkouts of the port, on one card.

Usage: python3 tools/torch_sweep_ab.py ROOT [ROOT ...] [--steady N]
       [--seed S]

Each ROOT is a checkout holding ``pulsar_timing_gibbsspec_torch/``.  In
the order given, each runs in a process of its own (which builds that
checkout's kernels): ``chip_smoke.py`` phase 4's run, the 45-pulsar
synthetic CRN array at 64 chains, 20 warmup sweeps then ``--steady``
steady sweeps replayed from CUDA graphs, checkpointed every 100 sweeps.
Prints one JSON line per run (the root, the card's name and power limit,
steady sweeps/s and samples/s, per-block ms per steady sweep, the sha256
of the chain rows), then the lines again as one JSON list.  Give the
roots as parent, change, change, parent: the card's clocks drift within
a call, and two versions compare only within one call.
"""

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def one(root, steady, seed):
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import synthetic_array
    from pulsar_timing_gibbsspec_torch.ops.kernels import build

    where = Path(ptt.__file__).resolve()
    assert Path(root).resolve() in where.parents, where
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    t0 = time.perf_counter()
    build.library()
    built = time.perf_counter() - t0
    dev = torch.device("cuda")
    psrs = synthetic_array(npsr=45, seed=seed)
    cm = ptt.build_crn_spectrum(psrs, nbins=10, red_bins=10, device=dev)
    g = ptt.PTABlockGibbs(cm, nchains=64, device=dev, seed=seed,
                          warmup_sweeps=20, progress=False,
                          obs={"lags": 256})
    x0 = g.initial_sample(torch.Generator(device=dev).manual_seed(seed))
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        chain = g.sample(x0, outdir=Path(tmp) / "main",
                         niter=20 + 1 + steady, save_every=100)
    torch.cuda.synchronize()
    drv = g.driver
    sps = drv.steady_sweeps / drv.steady_seconds
    return {"root": str(root), "card": card, "build_s": built,
            "graphed": bool(drv.carry.graphed),
            "steady_sweeps": drv.steady_sweeps,
            "sweeps_per_s": sps, "samples_per_s": sps * 64,
            "block_ms": {k: v / drv.steady_sweeps
                         for k, v in sorted(drv.timer.ms.items())},
            "chain_sha256": hashlib.sha256(chain.tobytes()).hexdigest()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--steady", type=int, default=240)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.roots[0], args.steady, args.seed)),
              flush=True)
        return 0
    out, rc = [], 0
    for root in args.roots:
        p = subprocess.run(
            [sys.executable, __file__, root, "--one", "--steady",
             str(args.steady), "--seed", str(args.seed)],
            capture_output=True, text=True)
        if p.returncode:
            print(f"{root}: exit {p.returncode}\n{p.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
            rc = 1
            continue
        line = p.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        out.append(json.loads(line))
    print(json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
