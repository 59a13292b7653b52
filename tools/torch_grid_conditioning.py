#!/usr/bin/env python3
"""How well conditioned the b-systems are on the log frequency grid.

Usage: python3 tools/torch_grid_conditioning.py [--chains 4] [--seed 0]

Builds, in the port on the CPU, the synthetic 45-pulsar array with the
SVD timing model, a common free spectrum and ``pshift`` on several grids
(``logfreq``'s grid of 10 linear and 10 or 5 log-spaced frequencies,
given as ``modes``; 20 and 10 linear frequencies) and red noise as a
powerlaw or a free spectrum, takes ``chip_smoke.parity_state`` of
``--chains`` chains, forms ``Sigma = T^T N^-1 T + diag(1 / phi)`` (the
float64 factor's input in the b-marginalized likelihood) and prints, per
model, the 2-norm condition numbers of the Jacobi-scaled systems
(largest, median) and how many of them are not positive definite in
float64.  The log grid's lowest frequencies (from a hundredth of
1/Tspan) make sin/cos columns that are nearly polynomials over the span,
which the timing model's columns (variance 1e40) already span; only the
GP variance regularizes them, and a red powerlaw's variance there is
enormous.
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
    import numpy as np
    import torch

    import chip_smoke
    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import get_tspan, synthetic_array
    from pulsar_timing_gibbsspec_torch.models.build import log_grid
    from pulsar_timing_gibbsspec_torch.ops.linalg import _batched_diag
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    psrs = synthetic_array(npsr=45, seed=args.seed)
    tspan = get_tspan(psrs)
    cases = []
    for nlog in (10, 5):
        grid = log_grid(10, nlog, tspan)
        for red in ("powerlaw", "spectrum"):
            cases.append((f"log grid 10 + {nlog}, red {red}",
                          dict(modes=grid, common_components=len(grid),
                               red_psd=red, red_components=len(grid))))
    for n in (20, 10):
        cases.append((f"linear {n}, red powerlaw",
                      dict(common_components=n, red_psd="powerlaw",
                           red_components=n)))
    for label, kw in cases:
        cm = ptt.model_general(psrs, tm_svd=True, white_vary=True,
                               Tspan=tspan, common_psd="spectrum",
                               pshift=True, pseed=1, device="cpu", **kw)
        x = chip_smoke.parity_state(cm, args.chains,
                                    torch.Generator().manual_seed(args.seed))
        TNT, _ = blocks.tnt_d_x(cm, x, cm.ndiag(x))
        S = (TNT + _batched_diag(1.0 / cm.phi(x))).reshape(
            -1, cm.Bmax, cm.Bmax).double()
        dj = 1.0 / torch.sqrt(torch.diagonal(S, dim1=-2, dim2=-1))
        ev = torch.linalg.eigvalsh(S * dj[:, :, None] * dj[:, None, :])
        cond = (ev[:, -1] / ev[:, 0].clamp_min(1e-300)).numpy()
        bad = int((ev[:, 0] <= 0).sum())
        print(f"{label}: Bmax {cm.Bmax}, Jacobi-scaled condition largest "
              f"{cond.max():.3g}, median {np.median(cond):.3g}; not "
              f"positive definite {bad} of {len(cond)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
