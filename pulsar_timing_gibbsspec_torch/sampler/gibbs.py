"""User-facing facades of the port's Gibbs samplers.

``PulsarBlockGibbs(cm, nchains=C, device="cuda", seed=0)`` (one pulsar)
and ``PTABlockGibbs(cm, ...)`` (an array) run the sweep of :mod:`.driver`
on the compiled model ``cm``; they share :class:`_GibbsBase`, as the JAX
package's facades do.  ``.sample(x0, outdir, niter, resume=False,
save_every=100)`` is the JAX facade's (``pulsar_timing_gibbsspec_tpu/
sampler/gibbs.py::_GibbsBase.sample``): it writes ``chain.npy`` /
``bchain.npy`` (rows of the JAX layout), ``pars_chain.txt`` /
``pars_bchain.txt``, ``adapt.npz`` and ``manifest.json`` every
``save_every`` sweeps (rounded up to whole chunks) through
:class:`.chains.ChainStore`, and ``resume=True`` continues a verified
checkpoint bitwise.  A save runs on a thread while the driver samples the
next chunk (one save at a time; the run ends when its last save has).

``backend="numpy"`` runs the float64 NumPy oracle on the host in
place of the driver (:mod:`.numpy_backend`, :mod:`.numpy_pta`: one
chain, every sweep recorded in float64), whatever ``device`` says, as
the JAX facade's ``backend="numpy"`` does; it reads the model's host
arrays (:class:`.host_model.HostPTA`), never its device tensors.
:meth:`_GibbsBase.with_backend` makes the twin facade on the other
backend, and the oracle adopts a checkpoint of the card's driver
(:func:`_adopt_torch_checkpoint`) where the caller resumes one on it.
The supervisor never makes that move itself: a run given to the card
stays there (:mod:`..runtime.supervisor`).

The JAX facade's resilience branches come with it (:mod:`..runtime`):
new rows pass the ``nan_rows`` fault hook and the sentinels' host check
before they can be saved (a divergence leaves nothing to flush), the
``sample.loop`` seam fires after them, a preemption drain breaks the
loop, flushes, verifies the checkpoint (rolling back to ``.bak`` if it
was torn) and raises :class:`..runtime.preemption.Preempted`, and
``hdf5=True`` writes ``chain.h5`` at the end.  A failure between
checkpoints waits for the save in flight, then flushes every checked
row.

``mesh=`` (a :class:`..parallel.sharding.Mesh`, on every rank of its
world) shards the driver: :func:`..parallel.sharding.validate_chains`
and :func:`..parallel.sharding.shard_compiled` run here, and the
manifest's ``shard_map`` records the mesh.  Every rank holds the whole
logical chain; global rank 0 alone writes the chain files, the manifest
and the ``.bak`` (:attr:`_GibbsBase.writer`), and every rank learns the
outcome of each save (a broadcast) and raises the writer's exception at
the same seam, so ``run_supervised`` retries all ranks in lock step.  A
resume is read by the writer and broadcast.
"""

from __future__ import annotations

import pickle
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import resolve_device
from ..parallel.sharding import mesh_layout
from ..runtime import faults, integrity, preemption, sentinels
from .blocks import validate_sampling_flags
from .chains import ChainStore
from .driver import RNG_RULE, TorchGibbsDriver

#: the backends a facade runs: the driver on ``cm``'s device, or the
#: NumPy oracle on the host
BACKENDS = ("torch", "numpy")
#: the driver's options that the oracle has no counterpart of: a
#: ``backend="numpy"`` facade refuses them (:func:`_reject_device_opts`)
#: and :meth:`_GibbsBase.with_backend` drops them
DEVICE_ONLY_OPTS = ("record_precision", "record_every", "chunk_size",
                    "graphs", "joint_mixed", "exact_every",
                    "white_steps_max", "warmup_white_steps",
                    "warmup_sweeps", "sentinels", "watchdog", "obs",
                    "ensemble", "pt_ladder", "mesh")


def prior_sample(cm, n, generator=None):
    """(n, nx) prior draw of the model ``cm`` on its device (``generator``:
    a torch.Generator on any device), each coordinate from its prior:
    uniform on ``[a, b]``, normal ``(a, b)``, LinearExp (``log10`` of a
    uniform on ``[10^a, 10^b]``) or InvGamma (shape ``a``, rate ``b``); a
    coordinate the model pins (``cm.pinit``: the sampled ORF weights, at
    0) starts there."""
    gdev = generator.device if generator is not None else cm.device
    shape = (n, cm.nx)
    f64 = torch.float64

    def draw(fn):
        return fn(shape, generator=generator, dtype=f64,
                  device=gdev).to(cm.device)

    u, z = draw(torch.rand), draw(torch.randn)
    pa, pb = cm.pa.to(f64), cm.pb.to(f64)
    shape_ig = torch.where(cm.pkind == 3, pa, torch.ones_like(pa))
    g = torch._standard_gamma(torch.broadcast_to(
        shape_ig.to(gdev), shape).contiguous(), generator)
    lo, hi = torch.pow(10.0, pa), torch.pow(10.0, pb)
    by_kind = (pa + (pb - pa) * u, pa + pb * z,
               torch.log10(lo + u * (hi - lo)), pb / g.to(cm.device))
    out = by_kind[0]
    for kind in (1, 2, 3):
        out = torch.where(cm.pkind == kind, by_kind[kind], out)
    if cm.pinit is not None:
        out = torch.where(torch.isnan(cm.pinit), out, cm.pinit)
    return out


class _GibbsBase:
    """What both facades share: the driver on ``cm``, the names, the
    initial draw and ``sample``.  ``hypersample``, ``ecorrsample`` and
    ``redsample`` are the reference's block-kernel selectors: ``None``
    lets the model choose; an explicit value is checked against the
    model as the JAX package checks it (``blocks.
    validate_sampling_flags``).  ``ecorrsample="kernel"`` (kernel ECORR)
    needs a model compiled with ``kernel_ecorr=True``, and such a model
    refuses ``ecorrsample="mh"``: the facade takes a compiled model and
    recompiles nothing.  The driver's options pass through, the JAX
    facade's ``ensemble``, ``pt_ladder`` and ``obs`` among them.
    ``backend`` is ``"torch"`` (the driver) or ``"numpy"`` (the host
    oracle, one chain: :data:`DEVICE_ONLY_OPTS` raise ``ValueError``);
    :attr:`backend_name` names it to the supervisor and the metrics."""

    def __init__(self, cm, nchains=1, device="cuda", seed=0,
                 hypersample=None, ecorrsample=None, redsample=None,
                 progress=True, backend="torch", **driver_opts):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend '{backend}'")
        #: "torch" or "numpy"
        self.backend_name = backend
        # the constructor's arguments, for with_backend
        self._ctor = dict(nchains=nchains, device=device, seed=seed,
                          hypersample=hypersample, ecorrsample=ecorrsample,
                          redsample=redsample,
                          opts={k: v for k, v in driver_opts.items()
                                if k != "common_rho"})
        if backend == "torch":
            dev = resolve_device(device)
            if cm.device != dev:
                raise ValueError(f"the model lives on {cm.device} but the "
                                 f"sampler was asked to run on {dev}")
        validate_sampling_flags(cm, hypersample, ecorrsample, redsample)
        if ecorrsample == "kernel" and not cm.has_ke:
            raise ValueError(
                "ecorrsample='kernel' needs a model compiled with kernel "
                "ECORR: build it with model_general(..., kernel_ecorr=True) "
                "(this model carries basis ECORR columns)")
        if ecorrsample == "mh" and cm.has_ke:
            raise ValueError(
                "ecorrsample='mh' samples basis ECORR, but this model was "
                "compiled with kernel_ecorr=True (ECORR inside N): build it "
                "without kernel_ecorr, or pass ecorrsample='kernel'")
        self.cm = cm
        #: the mesh the driver is sharded over (None: one model), and
        #: whether this rank writes the checkpoint (global rank 0)
        self.mesh = None
        self.writer = True
        #: print a progress line at each checkpoint (``\r``-rewritten on
        #: a terminal, one line per checkpoint otherwise)
        self.progress = progress
        if backend == "numpy":
            driver_opts.pop("common_rho", None)
            _reject_device_opts(driver_opts)
            if nchains != 1:
                raise ValueError(
                    f"nchains={nchains}: the numpy oracle backend runs one "
                    "chain; use backend='torch' for several")
            self.driver = self._make_numpy(hypersample, ecorrsample,
                                           redsample, seed, driver_opts)
        else:
            mesh = driver_opts.pop("mesh", None)
            run_cm = cm
            if mesh is not None:
                from ..parallel.sharding import (shard_compiled,
                                                 validate_chains)

                validate_chains(mesh, nchains)
                run_cm = shard_compiled(cm, mesh)
                self.mesh, self.writer = mesh, mesh.rank == 0
                self.progress = progress and self.writer
            self.driver = TorchGibbsDriver(run_cm, nchains=nchains,
                                           seed=seed, **driver_opts)
        self.chain = self.bchain = None
        #: host seconds the last sample()'s loop spent on checkpoints:
        #: taking the state, and waiting for a save still running on its
        #: thread (the store's ``seconds`` hold the saves' own time)
        self.save_seconds = 0.0
        #: the chain store of the last sample() (its ``seconds`` split the
        #: saves by step)
        self.store = None

    def with_backend(self, backend):
        """The twin facade on the same model with another backend: the
        constructor's arguments again, less :data:`DEVICE_ONLY_OPTS` and
        at one chain for ``"numpy"``, as the JAX facade's
        ``with_backend`` drops its device-only options."""
        c = self._ctor
        opts, nchains = dict(c["opts"]), c["nchains"]
        if backend == "numpy":
            for k in DEVICE_ONLY_OPTS:
                opts.pop(k, None)
            nchains = 1
        return type(self)(self.cm, nchains=nchains, device=c["device"],
                          seed=c["seed"], hypersample=c["hypersample"],
                          ecorrsample=c["ecorrsample"],
                          redsample=c["redsample"], progress=self.progress,
                          backend=backend, **opts)

    def obs_summary(self):
        """The device sketch finalized (driver option ``obs``):
        :meth:`.driver.TorchGibbsDriver.obs_summary`."""
        return self.driver.obs_summary()

    def ensemble_summary(self):
        """The ensemble stage's roll-up (driver options ``ensemble``,
        ``pt_ladder``), None without it (and on the oracle):
        :meth:`.driver.TorchGibbsDriver.ensemble_summary`."""
        if self.backend_name == "numpy":
            return None
        return self.driver.ensemble_summary()

    @property
    def params(self):
        """The sampled parameters (:meth:`.compiled.CompiledPTA.params`)."""
        return self.cm.params()

    @property
    def param_names(self):
        return list(self.cm.param_names)

    def map_params(self, xs):
        """``{name: value}`` of one chain vector."""
        return self.cm.map_params(xs)

    @property
    def b_param_names(self):
        return self.cm.b_param_names()

    def initial_sample(self, generator=None):
        """(C, nx) prior draw, one start per chain, on the model's device
        (``generator``: a torch.Generator on any device):
        :func:`prior_sample`."""
        return prior_sample(self.cm, self.driver.C, generator)

    def _checkpoint_extra(self):
        """The manifest's ``layout`` section: the logical identity of
        the sampled process (facade, chains, pulsars, padded width,
        thinning, the sweep options that change the stream, a correlated
        ORF's b-draw, stream rule and the device type its streams come
        from)."""
        drv = self.driver
        if self.backend_name == "numpy":
            return {"layout": {"facade": type(self).__name__,
                               "backend": "numpy", "nchains": 1,
                               "record_every": 1,
                               "pulsars": [str(p) for p in self.cm.pulsars],
                               "rng": NUMPY_RNG_RULE},
                    "shard_map": None}
        return {"layout": {"facade": type(self).__name__,
                           "backend": "torch",
                           "nchains": drv.C,
                           "record_every": drv.record_every,
                           **drv.stream_options(),
                           **({"hd_kernel": drv.hd_kernel}
                              if drv.hd_kernel is not None else {}),
                           "pulsars": [str(p) for p in self.cm.pulsars],
                           "pad_pulsars": int(self.cm.P),
                           "rng": RNG_RULE,
                           "rng_device": drv.gen.device.type},
                "shard_map": mesh_layout(self.mesh)}

    def _agree(self, fn):
        """``fn()`` on the writer, its outcome on every rank: the value,
        or the writer's exception raised on every rank (``fn`` None:
        nothing runs)."""
        out = err = sent = err2 = None
        if self.writer and fn is not None:
            try:
                out = fn()
            except Exception as exc:
                err = exc
        if self.mesh is not None:
            sent = err
            try:
                pickle.dumps(err)
            except Exception:
                # every rank must get the message, whatever the exception
                sent = RuntimeError(f"{type(err).__name__}: {err}")
            out, err2 = self.mesh.broadcast_object((out, sent))
            if not self.writer:
                err = err2
        if err is None:
            return out
        raise err

    def sample(self, x0, outdir="./chains", niter=10000, resume=False,
               save_every=100, backup=True, hdf5=False):
        """Run an ``niter``-sweep chain from ``x0`` ((nx,) or (C, nx)),
        checkpointing to ``outdir``; with ``resume=True``, continue the
        verified checkpoint there.  ``backup=False`` keeps no ``.bak``
        generation (:class:`.chains.ChainStore`); ``hdf5=True`` also
        writes ``chain.h5`` at the end.  Returns the chain rows (the
        chains axis dropped at C = 1).  A preemption drain raises
        :class:`..runtime.preemption.Preempted` once the checkpoint is
        verified."""
        drv = self.driver
        if torch.is_tensor(x0):
            x0 = x0.cpu().numpy()
        xs = np.atleast_1d(np.asarray(x0, dtype=np.float64))
        npar = len(self.param_names)
        C = drv.C
        ok_shapes = [(npar,)] + ([(C, npar)] if C > 1 else [])
        if xs.shape not in ok_shapes:
            raise ValueError(
                f"x0 has shape {xs.shape}; this model has {npar} parameters "
                f"(see .param_names)" + (f" and {C} chains" if C > 1 else ""))
        store = self.store = ChainStore(outdir, self.param_names,
                                        self.b_param_names, backup=backup,
                                        writer=self.writer)
        cshape, bshape = drv.chain_shapes(niter)
        total_rows = cshape[0]
        rec_k = drv.record_every
        chain = np.zeros(cshape)
        bchain = np.zeros(bshape)
        start = 0
        x = xs
        if resume:
            # the writer reads (verifying, rolling back), every rank gets it
            got, layout = self._agree(lambda: (
                store.load_resume(),
                (integrity.read_manifest(outdir) or {}).get("layout")
                or {}))
            if got is not None:
                prev_c, prev_b, upto, adapt = got
                upto = min(upto, total_rows)
                if prev_c.shape[1:] != chain.shape[1:]:
                    raise RuntimeError(
                        f"{outdir}: cannot resume — saved chain rows have "
                        f"shape {prev_c.shape[1:]} but this sampler "
                        f"(nchains={C}) produces {chain.shape[1:]}; resume "
                        "with the original nchains or start fresh")
                chain[:upto] = prev_c[:upto]
                bchain[:upto] = prev_b[:upto]
                start = upto
                if upto > 0:
                    x = chain[upto - 1].copy()
                if adapt is not None:
                    if "rng_device" in layout:
                        adapt = {**adapt, "rng_device": layout["rng_device"]}
                    drv.load_adapt_state(adapt)
                    # the post-sweep carry (never a chain row yet):
                    # resuming from it replays the uninterrupted run
                    x = drv.x_cur
                elif upto > 0:
                    raise RuntimeError(
                        f"{outdir}: chain files exist but adapt.npz is "
                        "missing; cannot resume the adapted sampler state "
                        "(delete the directory to start fresh)")

        t0 = time.time()
        self.save_seconds = 0.0
        last_saved = upto_done = start
        # save_every is in sweeps; yields count recorded rows
        save_rows = max(1, save_every // rec_k)
        ck_extra = self._checkpoint_extra()
        is_tty = bool(getattr(sys.stdout, "isatty", lambda: False)())
        # one save at a time runs on a thread beside the sampling loop,
        # which meanwhile queues the next chunk and writes only later rows
        saver = ThreadPoolExecutor(max_workers=1)
        inflight = None
        # no_flush: a save is in flight (a crash inside it must not be
        # saved again); diverged: rows past the last checkpoint are known
        # bad, and the driver's state already moved past them
        no_flush = diverged = drained = False

        def settle():
            """Wait for the save in flight; its error propagates (under a
            mesh the writer's, on every rank)."""
            nonlocal inflight, no_flush
            if inflight is not None:
                ts = time.perf_counter()
                fut, inflight = inflight, None
                self._agree(None if fut is True else fut.result)
                no_flush = False
                self.save_seconds += time.perf_counter() - ts

        def save(upto):
            nonlocal inflight, no_flush
            settle()
            ts = time.perf_counter()
            no_flush = True
            inflight = (saver.submit(store.save, chain, bchain, upto,
                                     adapt_state=drv.adapt_state(),
                                     extra=ck_extra)
                        if self.writer else True)
            self.save_seconds += time.perf_counter() - ts

        try:
            for upto in drv.run(x, chain, bchain, start, niter):
                faults.mutate_rows(chain, bchain, upto_done, upto,
                                   backend=self.backend_name)
                try:
                    sentinels.check_rows(chain, bchain, upto_done, upto)
                except sentinels.ChainDivergence as exc:
                    diverged = True
                    store.log_metrics({"event": "divergence",
                                       "row": exc.row, "what": exc.what,
                                       "backend": self.backend_name})
                    raise
                upto_done = upto
                faults.fire("sample.loop", row=upto,
                            backend=self.backend_name)
                # a drain request on the final row falls through: the
                # run is complete and its save below commits it
                if preemption.drain_requested() and upto < total_rows:
                    drained = True
                    store.log_metrics({"event": "drain_requested",
                                       "row": int(upto),
                                       **preemption.drain_info()})
                    break
                if upto - last_saved >= save_rows or upto >= total_rows:
                    save(upto)
                    if upto >= total_rows:
                        settle()     # the run ends with its last save
                    el = time.time() - t0
                    rate = ((upto - start) * rec_k / el if el > 0
                            else float("nan"))
                    store.log_metrics({
                        "iter": int(drv.it_cur), "niter": int(niter),
                        "graphs_off": getattr(drv, "graphs_off", None),
                        "rows": int(upto) if rec_k > 1 else None,
                        "elapsed_s": round(el, 3),
                        "sweeps_per_s": round(rate, 3),
                        "record_every": rec_k if rec_k > 1 else None,
                        "backend": self.backend_name, "nchains": C,
                        "sentinel": drv.health_last,
                        "aclength_white": drv.aclength_white,
                        "aclength_ecorr": drv.aclength_ecorr})
                    last_saved = upto
                    if self.progress:
                        msg = (f"[{self.backend_name}] {upto}/{total_rows} rows "
                               f"({rate:.1f} sweeps/s)")
                        if is_tty:
                            print("\r" + msg, end="", flush=True)
                        else:
                            print(msg, flush=True)
            settle()
        finally:
            try:
                settle()       # an exception left a save in flight
            except Exception as exc:
                # the exception in flight is the one to raise; record this
                store.log_metrics({"event": "save_failed",
                                   "error": repr(exc)})
            if upto_done > last_saved and not (no_flush or diverged):
                # bounded-loss flush: an interrupt, a failure between
                # checkpoints or a drain still persists every checked row
                try:
                    save(upto_done)
                    settle()
                    store.log_metrics({"event": "final_flush",
                                       "rows": int(upto_done),
                                       "backend": self.backend_name})
                except Exception:
                    # never mask the original exception with a failed
                    # best-effort flush
                    pass
            saver.shutdown()
        # the driver also stops queueing chunks on a drain request; its
        # loop then just ends, so an incomplete run with the flag up is
        # a drain, not a completion
        drained = drained or (preemption.drain_requested()
                              and upto_done < total_rows)
        self.chain, self.bchain = chain, bchain
        if drained:
            # the flush is best effort: hand the supervisor a verified
            # checkpoint or say so, rolling back to .bak if it was torn
            def check():
                rep = integrity.verify(outdir)
                rolled = False
                if not rep["ok"]:
                    rolled = integrity.rollback(outdir)
                    rep = integrity.verify(outdir)
                return rep, rolled

            rep, rolled = self._agree(check)
            lat = preemption.mark_drained()
            store.log_metrics({"event": "preempted_drain",
                               "rows": int(rep["rows"]),
                               "verified": bool(rep["ok"]),
                               "rolled_back": rolled,
                               "latency_s": round(lat, 3),
                               **preemption.drain_info()})
            raise preemption.Preempted(
                f"{outdir}: drained to a "
                f"{'verified' if rep['ok'] else 'UNVERIFIED'} checkpoint "
                f"({rep['rows']} rows) after "
                f"{preemption.drain_info().get('reason', 'preemption')}",
                rows=rep["rows"], verified=rep["ok"], rolled_back=rolled)
        if self.progress and is_tty:
            print()
        if hdf5 and self.writer:
            store.export_hdf5(chain, bchain, total_rows,
                              extra_attrs={"backend": self.backend_name})
        return chain


class PulsarBlockGibbs(_GibbsBase):
    """Single-pulsar blocked Gibbs (the JAX package's
    ``PulsarBlockGibbs``): white, ECORR (basis, or kernel ECORR on a
    model compiled with ``kernel_ecorr=True``), red (free spectrum,
    t-process alphas), powerlaw hyper MH (red and/or common powerlaw),
    rho (inverse-CDF draw without intrinsic red noise, else the grid
    draw) and b blocks."""

    def __init__(self, cm, nchains=1, device="cuda", seed=0, **driver_opts):
        if cm.P_real != 1:
            raise ValueError(f"PulsarBlockGibbs samples one pulsar; the "
                             f"model holds {cm.P_real} (use PTABlockGibbs)")
        super().__init__(cm, nchains=nchains, device=device, seed=seed,
                         **driver_opts)

    def _make_numpy(self, hypersample, ecorrsample, redsample, seed, opts):
        from .numpy_backend import NumpyGibbs

        return _NumpyDriver(NumpyGibbs, self.cm, hypersample, ecorrsample,
                            redsample, seed, opts)


class PTABlockGibbs(_GibbsBase):
    """Multi-pulsar blocked Gibbs with a common free spectrum, under no
    ORF, a fixed correlated one (Hellings-Downs and the others of
    ``models/orf.py``: the joint b-draw over all pulsars; driver option
    ``joint_mixed``) or one with sampled correlation weights
    (``bin_orf``, ``legendre_orf``: their MH block ``orf_mh`` after the
    rho draw; ``initial_sample`` starts them at 0, G = I, and a start
    whose weights give a non-positive-definite G raises ``ValueError``).
    Past ``blocks.HD_DENSE_MAX`` coefficients the environment variable
    ``PTGIBBS_HD_KERNEL`` (read when the sampler is built) chooses the
    correlated-ORF b-draw: ``joint`` (the default), ``pulsar`` (the
    pulsar-wise sweep) or ``freq`` (the frequency-block sweep); a
    checkpoint records the choice, and a resume under another raises.
    As the JAX facade, it passes ``common_rho=True``: a model without a
    shared free spectrum raises ``ValueError``."""

    def __init__(self, cm, nchains=1, device="cuda", seed=0, **driver_opts):
        super().__init__(cm, nchains=nchains, device=device, seed=seed,
                         common_rho=True, **driver_opts)

    def _make_numpy(self, hypersample, ecorrsample, redsample, seed, opts):
        from .numpy_pta import NumpyPTAGibbs

        return _NumpyDriver(NumpyPTAGibbs, self.cm, hypersample,
                            ecorrsample, redsample, seed, opts)


#: the oracle's stream rule, written in the checkpoint's layout
NUMPY_RNG_RULE = ("numpy PCG64 Generator, its state in adapt.npz "
                  "rng_state; adopted from a torch checkpoint as "
                  "SeedSequence([0x6DE6, seed, it_cur])")


def _adopt_torch_checkpoint(drv, state):
    """Adopt a checkpoint of the card's driver into the oracle: resume
    from its one chain's ``x_cur``, seed a fresh generator
    deterministically from the checkpoint's ``(seed, it_cur)``, and have
    the first resumed sweep re-draw b and re-run the one-shot adaptation
    (the driver's adaptation state has no counterpart here).  The continuation is a valid Gibbs chain from the
    same state, not a replay of the card's stream."""
    xc = np.asarray(state["x_cur"], dtype=np.float64)
    if xc.ndim == 2:
        if xc.shape[0] != 1:
            raise RuntimeError(
                f"cannot resume a multi-chain (nchains={xc.shape[0]}) "
                "torch checkpoint on the single-chain numpy backend")
        xc = xc[0]
    drv.x_cur = xc
    ent = [0x6DE6, int(np.asarray(state["seed"])) % (1 << 64),
           int(np.asarray(state["it_cur"]))]
    drv.g.rng = np.random.default_rng(np.random.SeedSequence(ent))
    drv.readapt = True


def _reject_device_opts(opts):
    """A targeted error for a driver option reaching the float64 oracle
    (:data:`DEVICE_ONLY_OPTS`): the oracle records every sweep in float64
    on the host, so a silent accept would misstate what ran."""
    for opt in DEVICE_ONLY_OPTS:
        if opt in opts:
            raise ValueError(
                f"{opt!r} is a torch-backend option (it controls the "
                "card's driver or its records); the numpy oracle backend "
                "records every sweep in float64 on the host — drop the "
                "option or use backend='torch'")


class _NumpyDriver:
    """Adapter: the oracle's sweeps (``NumpyGibbs`` or ``NumpyPTAGibbs``
    on the model's host view) behind the driver protocol the facade's
    ``sample`` uses: one chain, every sweep a row."""

    C = 1
    record_every = 1
    health_last = None

    def __init__(self, cls, cm, hypersample, ecorrsample, redsample, seed,
                 opts):
        from .host_model import host_view

        self.g = cls(host_view(cm), hypersample=hypersample,
                     ecorrsample=ecorrsample, redsample=redsample,
                     seed=seed, **opts)
        self.nb_total = self.g.nb_total
        self.nx = len(cm.param_names)
        self.x_cur = None
        #: rows (sweeps) done at the last yield
        self.it_cur = 0
        #: the first resumed sweep re-draws b and adapts again (an
        #: adopted torch checkpoint)
        self.readapt = False

    @property
    def aclength_white(self):
        return self.g.aclength_white

    @property
    def aclength_ecorr(self):
        return self.g.aclength_ecorr

    def chain_shapes(self, niter):
        return (niter, self.nx), (niter, self.nb_total)

    def _b_flat(self):
        b = self.g.b
        return np.concatenate(b) if isinstance(b, list) else b

    def run(self, x, chain, bchain, start, niter):
        first = start == 0
        readapt, self.readapt = self.readapt, False
        self.x_cur = np.asarray(x, dtype=np.float64).reshape(-1)
        for ii in range(start, niter):
            if readapt and ii == start:
                # an adopted checkpoint restored no b: draw it from the
                # resumed state before it is recorded
                self.g.draw_b(self.x_cur)
            chain[ii] = self.x_cur
            bchain[ii] = self._b_flat()
            self.x_cur = self.g.sweep(
                self.x_cur,
                first=(first and ii == 0) or (readapt and ii == start))
            self.it_cur = ii + 1
            yield ii + 1

    def adapt_state(self):
        out = self.g.adapt_state()
        out["x_cur"] = np.asarray(self.x_cur)
        return out

    def load_adapt_state(self, state):
        state = dict(state)
        if "rng_state" not in state and "it_cur" in state:
            _adopt_torch_checkpoint(self, state)
            return
        if "x_cur" in state:
            self.x_cur = np.asarray(state.pop("x_cur"))
        self.g.load_adapt_state(state)
