#!/usr/bin/env python3
"""Which float64 joint b-draws of the Hellings-Downs warmup keep their b,
and does the JAX package's draw fail at the same states?

Usage: python3 tools/torch_hd_keep_probe.py [--chains 4] [--warmup 50]
[--seed 0] [--seeds 1]

Runs the port's ``PTABlockGibbs`` on the CPU on ``chip_smoke.py`` phase
10's model (the synthetic 45-pulsar array from ``--seed``, ``bench.py``'s
HD model: common and red free spectra of 10 bins under the
Hellings-Downs ORF) through the initial draw, ``--warmup`` warmup
sweeps and the adaptation, with ``--chains`` chains, for each of
``--seeds`` sampler seeds.  Every float64 structured joint draw is
watched: a chain whose draw was not finite (the driver keeps its b) is
recorded with its state.  For each such state, JAX's
``draw_b_joint_structured(exact=True)`` draws from a key and the port's
core from the normals that key gives; each side's draw is reported
finite or not, with the port's draw once more on the JAX package's
float32 noise vector N (the two frameworks' float32 ``pow`` differ in
the last bit), how many entries of N differ, where the port's draw
broke (stage 1: a pulsar's local block; else the Schur stage) and the
least eigenvalue of the Jacobi-scaled local blocks (float64
``eigvalsh`` of the float32-segment Gram's blocks).  The CPU
generator's streams are not the card's, so the card's warmup states are
not replayed: the probe asks whether the CPU run meets such states at
all, and whom they break.

One JSON line on standard output; progress on standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: phase 10's model options and its bins
HD_BINS = 10


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import numpy as np
    import torch

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import synthetic_array
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    opts = dict(tm_svd=True, white_vary=True, common_psd="spectrum",
                common_components=HD_BINS, red_psd="spectrum",
                red_components=HD_BINS, orf="hd")
    psrs = synthetic_array(npsr=45, seed=args.seed)
    cm = ptt.model_general(psrs, device="cpu", **opts)
    kept = []
    draws = [0]
    stage = ["init"]
    core = blocks.draw_b_joint_structured_core

    def watched(cm_, x, z, b=None, exact=False, **kw):
        out, ok = core(cm_, x, z, b, exact=exact, **kw)
        if exact:
            draws[0] += int(ok.numel())
            for c in torch.nonzero(~ok).flatten().tolist():
                kept.append(dict(x=x[c].numpy().copy(), stage=stage[0],
                                 chain=c))
        return out, ok

    blocks.draw_b_joint_structured_core = watched
    t0 = time.perf_counter()
    runs = []
    for s in range(args.seeds):
        g = ptt.PTABlockGibbs(cm, nchains=args.chains, device="cpu",
                              seed=args.seed + s,
                              warmup_sweeps=args.warmup, progress=False)
        x0 = g.initial_sample(torch.Generator().manual_seed(args.seed + s))
        with tempfile.TemporaryDirectory() as tmp:
            stage[0] = f"sampler seed {args.seed + s}"
            g.sample(x0, outdir=tmp, niter=args.warmup + 2)
        runs.append(dict(seed=args.seed + s, kept=g.driver.kept_by_stage))
        print(f"seed {args.seed + s}: kept {g.driver.kept_by_stage}, "
              f"{time.perf_counter() - t0:.0f} s", file=sys.stderr,
              flush=True)
    blocks.draw_b_joint_structured_core = core

    found = []
    if kept:
        import jax
        import jax.numpy as jnp
        import jax.random as jr

        from pulsar_timing_gibbsspec_tpu.data.dataset import Pulsar
        from pulsar_timing_gibbsspec_tpu.models.factory import model_general
        from pulsar_timing_gibbsspec_tpu.sampler import jax_backend as jb
        from pulsar_timing_gibbsspec_tpu.sampler.compiled import compile_pta

        jax.config.update("jax_enable_x64", True)
        cmj = compile_pta(model_general(
            [Pulsar(**dataclasses.asdict(p)) for p in psrs], **opts))
        n = blocks._joint_dim(cm)
        mark = 1234.5

        @jax.jit
        def jax_draw(x, k):
            b = jnp.full((cmj.P, cmj.Bmax), mark, cmj.cdtype)
            return (jb.draw_b_joint_structured(cmj, x, k, b=b, exact=True),
                    jr.normal(k, (n,), dtype=cmj.cdtype), cmj.ndiag_fast(x))

        own_n = cm.ndiag_fast
        for i, rec in enumerate(kept):
            bj, z, nj = map(np.array, jax_draw(jnp.asarray(rec["x"]),
                                               jr.PRNGKey(i)))
            xt = torch.as_tensor(rec["x"])[None]
            zt = torch.as_tensor(z)[None]
            _, ok = core(cm, xt, zt, exact=True)
            n_own = own_n(xt)[0].numpy()
            cm.ndiag_fast = lambda x: torch.as_tensor(nj).expand(
                x.shape[:-1] + nj.shape)
            try:
                _, ok_jn = core(cm, xt, zt, exact=True)
            finally:
                cm.ndiag_fast = own_n
            f = blocks.joint_factor_cache(cm, xt, exact=True)
            broke = torch.nonzero(~torch.isfinite(f.Li1[0]).all(-1).all(
                -1)).flatten().tolist()
            Snn = blocks._joint_perm_parts(cm, xt)[5][0]
            dj = 1.0 / torch.sqrt(torch.diagonal(Snn, dim1=-2, dim2=-1))
            ev = torch.linalg.eigvalsh(Snn * dj[:, :, None]
                                       * dj[:, None, :]).min(-1).values
            found.append(dict(
                stage=rec["stage"], chain=rec["chain"],
                jax_finite=not bool((bj == mark).all()),
                port_finite=bool(ok.all()),
                port_finite_on_jax_N=bool(ok_jn.all()),
                N_entries_differing=int((n_own != nj).sum()),
                broke_in=(f"stage 1, pulsars {broke}" if broke
                          else "the Schur stage"),
                least_local_eigenvalue=float(ev.min()),
                at_pulsar=int(ev.argmin())))
    print(json.dumps({"model": "chip_smoke phase 10 (45 pulsars, HD, 10 "
                      "bins)", "chains": args.chains,
                      "warmup": args.warmup, "float64_draws": draws[0],
                      "runs": runs, "kept_states": found,
                      "seconds": round(time.perf_counter() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
