"""The steady sweep replayed from CUDA graphs.

The port's counterpart of the JAX package's compiled chunk program
(``jax_backend.py::_make_chunk``): after adaptation every shape of the
steady sweep is fixed (the white and ECORR sub-chain lengths
``aclength_white`` and ``aclength_ecorr`` included), so each of its
blocks (white, ecorr, red or tprocess, red_mh, rho, scale, orf_mh,
b_mh, b_refresh; under a correlated ORF b_joint and b_joint_exact; under
kernel ECORR the one b_exact: as the model has them), the ensemble
stage's (asis, stretch, and a tempering swap of each parity,
pt_swap_even and pt_swap_odd) and the sketch's fold (sketch) is captured
once as a CUDA graph and a sweep is a few graph launches in place of
thousands of kernel launches from the host.

- ``x``, ``b``, ``u = T b`` and the acceptance counters live in static
  buffers that every graph reads and writes in place; so do the powerlaw
  block's adapted ``U``, ``S`` and its DE history, which the driver
  refills in place between replays when a DE period starts
  (``driver._de_select``).  The ensemble state (the tempering ladder and
  the stage's counters) and the sketch are static buffers too, updated
  in place by their graphs; a chain's beta is computed from the ladder
  on the device inside each graph that needs it, never read back between
  replays.
- The driver's generator is registered with every graph, so a replay
  draws from the generator's current seed and offset and advances the
  offset by what the capture drew; the driver re-seeds it between
  replays (never during a capture), and a replay after
  ``manual_seed(s)`` draws what the eager block draws from offset 0.
- Each block is run once on copies of the state, on the capturing
  stream, before it is captured: the kernels load and the library
  handles and workspaces are made outside the capture.
- The kernels count their own runs on the card, replays included
  (``ops.kernels.device_launches``).  :attr:`SteadyGraphs.launches` holds
  the launches each capture recorded and :attr:`SteadyGraphs.replays` the
  replays of each graph, so the runs the replays should have made can be
  held against the device's count since the captures
  (:meth:`SteadyGraphs.replayed_launches`, :attr:`SteadyGraphs.
  device_at_capture`).
- A capture failure raises: there is no quiet return to the eager sweep.
  The cyclic garbage collector is run before the captures and held off
  during them: a driver and its carry refer to each other, so only the
  collector frees an unreachable sampler's graphs, and graphs destroyed
  inside a capture would invalidate it.
"""

from __future__ import annotations

import collections
import gc
import time

import torch

from ..ops import kernels
from . import blocks
from .ensemble import TIMER_NAME


class SteadyGraphs:
    """One CUDA graph per steady block of ``drv`` (a
    :class:`.driver.TorchGibbsDriver` after adaptation), captured around
    static copies of ``x`` (C, nx) and ``b`` (C, P, Bmax)."""

    graphed = True

    def __init__(self, drv, x, b):
        cm = drv.cm
        if cm.device.type != "cuda":
            raise ValueError("CUDA graphs need a model on a cuda device")
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this PyTorch cannot register a generator with a CUDA "
                "graph (CUDAGraph.register_generator_state); run the "
                "driver with graphs=False")
        self.drv = drv
        self.x = x.clone()
        self.b = b.clone()
        self.u = blocks.b_matvec(cm, self.b)
        names = dict.fromkeys(drv.sweep_order(False, 0)
                              + drv.sweep_order(True, 1))
        stream = torch.cuda.Stream(cm.device)
        torch.cuda.synchronize(cm.device)
        t0 = time.perf_counter()
        # state the warm-up pass below moves, restored after it
        counters = (drv.b_mh_accepts, drv.b_refresh_accepts,
                    drv.red_mh_accepts, drv.orf_mh_accepts,
                    drv.b_joint_breakdowns,
                    *(drv.ens_state or {}).values(),
                    *(drv._obs_state or {}).values(),
                    *(() if drv._obs_prev is None else (drv._obs_prev,)))
        acc0 = [c.clone() for c in counters]
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for name in names:
                drv.block(name, self.x.clone(), self.b.clone(),
                          self.u.clone())
        torch.cuda.current_stream().wait_stream(stream)
        for c, c0 in zip(counters, acc0):
            c.copy_(c0)
        torch.cuda.synchronize(cm.device)
        # every capture empties the allocator's cache first; so does this
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved(cm.device)
        pool = torch.cuda.graph_pool_handle()
        #: the graphs, and the kernel launches ``{(kernel, form): n}``
        #: each capture recorded, by block
        self.graphs, self.launches = {}, {}
        #: host seconds and pool bytes each capture took, by block
        self.capture_by, self.pool_by = {}, {}
        # an unreachable sampler's graphs must not be destroyed by the
        # cyclic collector while a capture is open (that invalidates it)
        gc.collect()
        gc.disable()
        try:
            for name in names:
                tc = time.perf_counter()
                mc = torch.cuda.memory_reserved(cm.device)
                g = torch.cuda.CUDAGraph()
                g.register_generator_state(drv.gen)
                before = kernels.launch_counts()
                with torch.cuda.graph(g, pool=pool, stream=stream):
                    x, b, u = drv.block(name, self.x, self.b, self.u)
                    for dst, src in ((self.x, x), (self.b, b),
                                     (self.u, u)):
                        if src is not dst:
                            dst.copy_(src)
                after = kernels.launch_counts()
                self.graphs[name] = g
                self.launches[name] = {k: after[k] - before[k]
                                       for k in after
                                       if after[k] != before[k]}
                self.capture_by[name] = time.perf_counter() - tc
                self.pool_by[name] = (torch.cuda.memory_reserved(cm.device)
                                      - mc)
        finally:
            gc.enable()
        torch.cuda.synchronize(cm.device)
        #: host seconds of the warm-up pass and the captures
        self.capture_seconds = time.perf_counter() - t0
        #: device memory the captures reserved (the graphs' pool)
        self.pool_bytes = torch.cuda.memory_reserved(cm.device) - mem0
        #: the kernels' device counts once the captures are done
        self.device_at_capture = kernels.device_launches()
        #: replays of each graph
        self.replays = collections.Counter()

    def replayed_launches(self):
        """``{(kernel, form): n}``: the kernel runs the replays so far
        should have made (each capture's launches times its replays)."""
        out = collections.Counter()
        for name, counts in self.launches.items():
            for key, n in counts.items():
                out[key] += n * self.replays[name]
        return dict(out)

    def reset_u(self):
        """``u = T b`` afresh, into the static buffer."""
        self.u.copy_(blocks.b_matvec(self.drv.cm, self.b))

    def sweep(self, exact, t):
        """Replay steady sweep ``t``'s graphs in the JAX order
        (``drv.sweep_order``), each inside the driver's block timer."""
        drv = self.drv
        for name in drv.sweep_order(exact, t):
            with drv.timer(TIMER_NAME.get(name, name)):
                self.graphs[name].replay()
            self.replays[name] += 1
