#!/usr/bin/env python3
"""How well conditioned the float64 factor's systems are on the standard
noise model, and how far two float64 factor chains differ on them.

Usage: python3 tools/torch_factor_conditioning.py [--chains 4] [--seed 0]

Builds ``chip_smoke.py`` phase 11's model in the port on the CPU (the
synthetic 45-pulsar array, fixed white noise from the seeded noise
dictionary, a common free spectrum, red and DM powerlaws, ``dm_annual``;
Bmax 59), and the same model without ``dm_annual`` and without the DM
GP, takes ``chip_smoke.parity_state`` of ``--chains`` chains, and forms
the b-marginalized likelihood's systems ``Sigma = T^T N^-1 T + diag(1 /
phi)`` (the float64 factor's input in the adaptation).  For each model
it prints the 2-norm condition numbers of the Jacobi-scaled systems
(largest, median), and the largest difference of the mean ``Sigma^-1
d`` between the port's plain float64 chain and the library chain
(``torch.linalg.cholesky`` and ``solve_triangular``), over the largest
mean: the spread of two float64 orders of operation that phase 2's
float64 check allows the kernel.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    import chip_smoke
    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import (synthetic_array,
                                                    synthetic_noisedict)
    from pulsar_timing_gibbsspec_torch.ops.kernels import reference
    from pulsar_timing_gibbsspec_torch.ops.linalg import _batched_diag
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    psrs = synthetic_array(npsr=45, seed=args.seed)
    nd = synthetic_noisedict(psrs, args.seed, ecorr=False)
    for label, extra in (("phase 11", dict(dm_var=True, dm_annual=True)),
                         ("without dm_annual", dict(dm_var=True)),
                         ("without the DM GP", {})):
        cm = ptt.model_general(
            psrs, tm_svd=True, white_vary=False, noisedict=nd,
            common_psd="spectrum", common_components=10, red_psd="powerlaw",
            red_components=10, dm_components=10, device="cpu", **extra)
        x = chip_smoke.parity_state(
            cm, args.chains, torch.Generator().manual_seed(args.seed))
        n = cm.Bmax
        TNT, d = blocks.tnt_d_x(cm, x, cm.ndiag(x))
        Sig = (TNT + _batched_diag(1.0 / cm.phi(x))).reshape(-1, n, n)
        d = d.reshape(-1, n)
        z = torch.zeros_like(d)
        _, _, dj, mean, _ = reference.chol_solve_sample_ref(Sig, d, z)
        lib = chip_smoke.library_factor(Sig, d, z, 0.0)[3]
        cond = torch.linalg.cond(Sig * dj[:, :, None] * dj[:, None, :])
        spread = ((lib - mean).abs().max() / mean.abs().max()).item()
        print(f"{label}: {Sig.shape[0]} systems of order {n}; Jacobi-scaled "
              f"condition number largest {cond.max().item():.3e}, median "
              f"{cond.median().item():.3e}; plain vs library chain mean "
              f"{spread:.3e} of the largest mean", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
