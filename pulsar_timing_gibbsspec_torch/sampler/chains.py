"""Chain persistence: periodic checkpoints, resume, adaptation state.

The port's copy of ``pulsar_timing_gibbsspec_tpu/sampler/chains.py::
ChainStore``.  Each
save rotates the previous verified checkpoint to a ``.bak`` generation,
writes ``chain.npy`` / ``bchain.npy`` / ``adapt.npz`` through tmp files
and ``os.replace``, and writes ``manifest.json``
(:mod:`..runtime.integrity`) LAST; resume verifies the set against it,
rolls back to ``.bak`` on a mismatch, and only then trusts the files.
The fault seams ``chainstore.between_replaces`` and
``chainstore.post_save`` (:mod:`..runtime.faults`) let the chaos tests
tear or damage a checkpoint at a given row; ``export_hdf5`` writes the
JAX package's ``chain.h5``.
"""

from __future__ import annotations

import collections
import json
import os
import time
import warnings
from pathlib import Path

import numpy as np

from ..runtime import faults, integrity, telemetry


class ChainStore:
    """Directory of: chain.npy, bchain.npy, pars_chain.txt,
    pars_bchain.txt, adapt.npz, metrics.jsonl (+ manifest.json and, with
    ``backup``, one rotating .bak generation; without it a torn save
    leaves no set to roll back to, and resume still verifies the
    manifest).  ``writer=False`` (a rank of a mesh other than the
    writer) writes nothing: no names, no metrics."""

    def __init__(self, outdir, param_names, b_param_names, backup=True,
                 writer=True):
        self.outdir = Path(outdir)
        self.param_names = list(param_names)
        self.b_param_names = list(b_param_names)
        #: this process writes the directory (False: another rank of a
        #: mesh does, and this store writes nothing)
        self.writer = bool(writer)
        #: keep a rotating .bak of the previous verified checkpoint set
        self.backup = bool(backup)
        #: host seconds of the saves so far, by step: "rotate" (verify
        #: the previous set, link it to .bak), "write" (chain, bchain,
        #: adapt.npz), "manifest" (hash the new set)
        self.seconds = collections.Counter()
        if not self.writer:
            return
        self.outdir.mkdir(parents=True, exist_ok=True)
        np.savetxt(self.outdir / "pars_chain.txt", self.param_names,
                   fmt="%s")
        np.savetxt(self.outdir / "pars_bchain.txt", self.b_param_names,
                   fmt="%s")

    def save(self, chain, bchain, upto, adapt_state=None, extra=None):
        """Persist rows [0, upto) plus adaptation state: each file through
        a tmp file and ``os.replace``, the manifest last, so any torn
        combination is detectable.  ``extra`` is merged into
        ``manifest.json`` (the facade's ``layout`` section)."""
        t0 = time.perf_counter()
        if self.backup:
            # rotate BEFORE touching the primaries: a kill anywhere in
            # this save leaves the .bak holding the previous checkpoint
            integrity.rotate_backup(self.outdir)
        t1 = time.perf_counter()
        for nm, arr in (("chain.npy", chain), ("bchain.npy", bchain)):
            tmp = self.outdir / (nm + ".tmp.npy")
            np.save(tmp, arr[:upto])
            os.replace(tmp, self.outdir / nm)
            if nm == "chain.npy":
                faults.fire("chainstore.between_replaces", row=upto,
                            outdir=self.outdir)
        if adapt_state is not None:
            tmp = self.outdir / "adapt.npz.tmp.npz"
            np.savez(tmp, iter=np.int64(upto), **adapt_state)
            os.replace(tmp, self.outdir / "adapt.npz")
        t2 = time.perf_counter()
        integrity.write_manifest(self.outdir, rows=upto, extra=extra)
        self.seconds.update(rotate=t1 - t0, write=t2 - t1,
                            manifest=time.perf_counter() - t2)
        faults.fire("chainstore.post_save", row=upto, outdir=self.outdir)

    def log_metrics(self, record: dict):
        """Append one JSON line to ``metrics.jsonl`` (iteration progress,
        rates, adaptation state); ``None`` values are left out."""
        if not self.writer:
            return
        record = {"ts": round(time.time(), 3),
                  **{k: v for k, v in record.items() if v is not None}}
        with open(self.outdir / "metrics.jsonl", "a") as fh:
            fh.write(json.dumps(record) + "\n")

    def export_hdf5(self, chain, bchain, upto, extra_attrs=None):
        """Write ``chain.h5``, the JAX package's HDF5 container: datasets
        ``chain`` and ``bchain`` (rows ``[0, upto)``), ``params`` and
        ``b_params`` (variable-length strings), the attribute ``niter``
        and ``extra_attrs``.  Imports ``h5py`` here and raises
        ``RuntimeError`` when it is missing."""
        try:
            import h5py
        except ImportError as exc:
            raise RuntimeError(
                "HDF5 export requires h5py (chain.npy/bchain.npy remain "
                "the canonical outputs)") from exc

        tmp = self.outdir / "chain.h5.tmp"
        try:
            with h5py.File(tmp, "w") as fh:
                fh.create_dataset("chain", data=np.asarray(chain[:upto]))
                fh.create_dataset("bchain", data=np.asarray(bchain[:upto]))
                st = h5py.string_dtype()
                fh.create_dataset("params", data=np.asarray(
                    self.param_names, dtype=st))
                fh.create_dataset("b_params", data=np.asarray(
                    self.b_param_names, dtype=st))
                fh.attrs["niter"] = int(upto)
                for k, v in (extra_attrs or {}).items():
                    fh.attrs[k] = v
            os.replace(tmp, self.outdir / "chain.h5")
        finally:
            # a failed export leaves no tmp for a later one to promote
            tmp.unlink(missing_ok=True)

    def load_resume(self, force_requeue=False):
        """Return ``(chain, bchain, start_row, adapt_state)``, or None if
        there is nothing to resume from.

        A directory the serving tier parked as quarantined is refused
        (:class:`..runtime.integrity.CheckpointError`) unless
        ``force_requeue`` (``integrity.check_not_quarantined``).

        With a ``manifest.json`` the set is verified first; a mismatch
        (torn write, truncation, bit rot) rolls back to the ``.bak``
        generation, and :class:`..runtime.integrity.CheckpointError` is
        raised when neither set verifies.  A directory without a
        manifest skips verification, but a chain/bchain row-count
        mismatch is reported with a warning and the common prefix
        taken."""
        man = integrity.read_manifest(self.outdir)
        integrity.check_not_quarantined(self.outdir, force_requeue, man)
        if man is not None:
            rep = integrity.verify(self.outdir, man)
            if not rep["ok"]:
                bad = ", ".join(rep["bad"])
                telemetry.incr("corrupt_checkpoints")
                self.log_metrics({"event": "checkpoint_corrupt",
                                  "files": rep["bad"]})
                if not integrity.rollback(self.outdir):
                    raise integrity.CheckpointError(
                        f"{self.outdir}: checkpoint failed integrity "
                        f"verification ({bad}) and no verified .bak "
                        "backup exists; delete the directory to start "
                        "fresh")
                warnings.warn(
                    f"{self.outdir}: checkpoint failed integrity "
                    f"verification ({bad}); rolled back to the previous "
                    ".bak checkpoint", RuntimeWarning, stacklevel=2)
                self.log_metrics({"event": "checkpoint_rollback"})
                man = integrity.read_manifest(self.outdir)
        cpath = self.outdir / "chain.npy"
        bpath = self.outdir / "bchain.npy"
        if not (cpath.exists() and bpath.exists()):
            return None
        chain = np.load(cpath)
        bchain = np.load(bpath)
        if len(chain) != len(bchain):
            torn = ("bchain.npy" if len(bchain) < len(chain)
                    else "chain.npy")
            warnings.warn(
                f"{self.outdir}: torn checkpoint: chain.npy has "
                f"{len(chain)} rows, bchain.npy has {len(bchain)} "
                f"({torn} is short); resuming from the common prefix",
                RuntimeWarning, stacklevel=2)
            self.log_metrics({"event": "torn_checkpoint", "file": torn,
                              "chain_rows": int(len(chain)),
                              "bchain_rows": int(len(bchain))})
            telemetry.incr("torn_checkpoints")
        upto = min(len(chain), len(bchain))
        if man is not None and not man.get("corrupt"):
            upto = min(upto, int(man.get("rows", upto)))
        adapt = None
        apath = self.outdir / "adapt.npz"
        if apath.exists():
            try:
                with np.load(apath) as z:
                    adapt = {k: z[k] for k in z.files}
            except Exception as exc:
                raise integrity.CheckpointError(
                    f"{self.outdir}/adapt.npz is unreadable ({exc}); the "
                    "adaptation state cannot be restored; delete the "
                    "directory to start fresh") from exc
            upto = min(upto, int(adapt.pop("iter")))
        return chain[:upto], bchain[:upto], upto, adapt
