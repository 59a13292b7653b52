"""User-facing facade of the port's PTA Gibbs sampler.

``PTABlockGibbs(cm, nchains=C, device="cuda", seed=0)`` runs the CRN
free-spectrum sweep of :mod:`.driver` on the compiled model ``cm``;
``.sample(x0, outdir, niter)`` writes ``chain.npy`` (niter, C, nx) and
``pars_chain.txt`` (one parameter name per line), the files of the JAX
facade (``pulsar_timing_gibbsspec_tpu/sampler/gibbs.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..config import resolve_device
from .driver import TorchGibbsDriver


class PTABlockGibbs:
    """Multi-pulsar blocked Gibbs with a common free spectrum."""

    def __init__(self, cm, nchains=1, device="cuda", seed=0, **driver_opts):
        dev = resolve_device(device)
        if cm.device != dev:
            raise ValueError(f"the model lives on {cm.device} but the "
                             f"sampler was asked to run on {dev}")
        self.cm = cm
        self.driver = TorchGibbsDriver(cm, nchains=nchains, seed=seed,
                                       **driver_opts)
        self.chain = None

    @property
    def param_names(self):
        return list(self.cm.param_names)

    def initial_sample(self, generator=None):
        """(C, nx) prior draw, one start per chain, on the model's device
        (``generator``: a torch.Generator on any device)."""
        cm = self.cm
        if bool((cm.pkind != 0).any()):
            raise NotImplementedError(
                "initial draws from non-uniform priors are not in the "
                "port yet")
        gdev = generator.device if generator is not None else cm.device
        u = torch.rand((self.driver.C, cm.nx), generator=generator,
                       dtype=torch.float64, device=gdev).to(cm.device)
        pa, pb = cm.pa.to(torch.float64), cm.pb.to(torch.float64)
        return pa + (pb - pa) * u

    def sample(self, x0, outdir="./chains", niter=10000):
        """Run ``niter`` rows from ``x0``; write and return the chain."""
        chain = self.driver.run(x0, niter)
        out = Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        np.save(out / "chain.npy", chain)
        np.savetxt(out / "pars_chain.txt", np.asarray(self.param_names),
                   fmt="%s")
        self.chain = chain
        return chain
