#!/usr/bin/env python3
"""How many device operations one Hellings-Downs joint b-draw issues.

Usage: python3 tools/torch_hd_op_count.py [--chains 1]

Builds ``bench.py``'s HD model in the port (the synthetic 45-pulsar
array, seed 0, 10 common and 10 red bins, ``orf="hd"``: Bmax 57) on the
CPU and counts, with a ``TorchDispatchMode``, the operations one joint
draw dispatches: the two-float steady draw (``b_joint``), the float64
draw (``b_joint_exact``) and the HD rho draw.  View operations (no
kernel on a card) are left out, so the count is the kernel launches the
draw would make on a card, eagerly or as nodes of a CUDA graph, up to
what PyTorch fuses.  The shape of every operation is that of the card's
run but the chains axis (one chain by default), which changes no count.
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: aten operations that only make a view (no kernel)
VIEWS = {"view", "_unsafe_view", "expand", "slice", "select", "transpose",
         "permute", "unsqueeze", "squeeze", "as_strided", "t", "diagonal",
         "alias", "reshape", "detach", "movedim", "_reshape_alias", "split",
         "unbind", "narrow"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import pulsar_timing_gibbsspec_torch as ptt
    from pulsar_timing_gibbsspec_torch.data import synthetic_array
    from pulsar_timing_gibbsspec_torch.sampler import blocks

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.by_op = collections.Counter()

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            name = func.__name__.split(".")[0]
            if name not in VIEWS:
                self.by_op[name] += 1
            return func(*a, **(kw or {}))

    torch.set_num_threads(4)
    cm = ptt.model_general(synthetic_array(npsr=45, seed=0), tm_svd=True,
                           white_vary=True, common_psd="spectrum",
                           common_components=10, red_psd="spectrum",
                           red_components=10, orf="hd", device="cpu")
    gen = torch.Generator().manual_seed(0)
    g = ptt.PTABlockGibbs(cm, nchains=args.chains, device="cpu")
    x = g.initial_sample(gen)
    x[:, cm.rho_ix_x] = -7.5
    b = torch.zeros((args.chains, cm.P, cm.Bmax), dtype=torch.float64)
    print(f"model: P {cm.P}, Bmax {cm.Bmax}, K {cm.K}, nx {cm.nx}; "
          f"{args.chains} chain(s)")
    for name, kw in (("b_joint (two-float)", dict(mixed=True)),
                     ("b_joint_exact (float64)", dict(exact=True))):
        with Count() as c:
            b, ok = blocks.draw_b_joint_structured(cm, x, gen, b, **kw)
        print(f"{name}: {sum(c.by_op.values())} operations, draws taken "
              f"{ok.tolist()}; most frequent {c.by_op.most_common(6)}")
    with Count() as c:
        blocks.rho_update(cm, x, b, gen)
    print(f"rho (quadratic form): {sum(c.by_op.values())} operations")


if __name__ == "__main__":
    main()
