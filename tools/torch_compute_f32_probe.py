#!/usr/bin/env python3
"""Does the JAX package's sampler give finite records under float32
compute (``PTGIBBS_COMPUTE=f32``: float32 storage and float32 state,
reductions and factors)?

Usage: python3 tools/torch_compute_f32_probe.py [--npsr 5] [--chains 4]
[--niter 300] [--seed 0]

Runs the JAX package's ``PTABlockGibbs`` (``backend="jax"``) on the CPU
on the port's headline model (``bench.py``'s CRN free spectrum: tm_svd,
varied white noise, red and common free spectra of 10 bins) over a
synthetic array of ``--npsr`` pulsars from ``--seed``, once under
``PTGIBBS_COMPUTE=f32`` and once under the default float64 compute, each
in a child process (the JAX ``Settings`` reads the variable when its
module is imported).  Each run reports whether every recorded row is
finite, the share of finite rows, the per-bin median of the common
log10_rho over the rows after the warmup, and the compiled model's
dtypes.  The port's model build refuses float32 compute or ports it
according to this answer.

One JSON line on standard output; progress on standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BINS = 10


def child(args):
    sys.path.insert(0, str(ROOT))
    import dataclasses

    import numpy as np

    from pulsar_timing_gibbsspec_torch.data import synthetic_array
    from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
    from pulsar_timing_gibbsspec_tpu.models.factory import model_general
    from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta
    from pulsar_timing_gibbsspec_tpu.sampler.gibbs import PTABlockGibbs

    psrs = [Pulsar(**dataclasses.asdict(p))
            for p in synthetic_array(npsr=args.npsr, seed=args.seed)]
    pta = model_general(psrs, tm_svd=True, white_vary=True,
                        common_psd="spectrum", common_components=BINS,
                        red_var=True, red_psd="spectrum",
                        red_components=BINS)
    cm = compile_pta(pta)
    x0 = pta.initial_sample(np.random.default_rng(args.seed))
    g = PTABlockGibbs(pta, backend="jax", nchains=args.chains,
                      seed=args.seed, progress=False,
                      warmup_sweeps=args.warmup)
    with tempfile.TemporaryDirectory() as d:
        chain = np.asarray(g.sample(x0, outdir=d, niter=args.niter))
    rows = chain.reshape(chain.shape[0], -1, chain.shape[-1])
    fin = np.isfinite(rows).all(axis=(1, 2))
    cols = np.asarray(cm.rho_ix_x)
    steady = rows[args.warmup + 1:]
    with np.errstate(all="ignore"):
        med = np.nanmedian(steady[:, :, cols], axis=(0, 1))
    print(json.dumps(dict(
        compute=os.environ.get("PTGIBBS_COMPUTE", "f64"),
        dtype=np.dtype(cm.dtype).name, cdtype=np.dtype(cm.cdtype).name,
        rows=int(rows.shape[0]), all_finite=bool(fin.all()),
        finite_share=float(fin.mean()),
        first_nonfinite_row=(None if fin.all()
                             else int(np.argmin(fin))),
        rho_median=[float(v) for v in med])))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--npsr", type=int, default=5)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--niter", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        return child(args)
    out = {}
    for compute in ("f32", "f64"):
        env = dict(os.environ, PTGIBBS_COMPUTE=compute,
                   JAX_PLATFORMS="cpu")
        env.pop("PTGIBBS_PRECISION", None)
        print(f"running compute={compute}", file=sys.stderr)
        res = subprocess.run(
            [sys.executable, __file__, "--child", "--npsr", str(args.npsr),
             "--chains", str(args.chains), "--niter", str(args.niter),
             "--warmup", str(args.warmup), "--seed", str(args.seed)],
            env=env, capture_output=True, text=True, check=False)
        if res.returncode:
            out[compute] = dict(error=res.stderr[-2000:])
        else:
            out[compute] = json.loads(res.stdout.strip().splitlines()[-1])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
