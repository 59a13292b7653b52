"""Checkpoint integrity: manifest sidecar, verification, rotating .bak.

The port's copy of the subset of ``pulsar_timing_gibbsspec_tpu/runtime/
integrity.py`` that the chain store needs.  ``ChainStore.save`` is atomic
per file (tmp + ``os.replace``) but not across files; this module makes
the checkpoint SET verifiable:

- ``manifest.json``, written (atomically, last) by every save: schema
  version, row count, and per-file sha256/size/shape/dtype for
  ``chain.npy``/``bchain.npy``/``adapt.npz``.  Any file that does not
  match its manifest entry marks the whole set torn or corrupt.  The
  format is the JAX package's, byte for byte, so either package verifies
  a directory the other wrote.
- ``*.bak`` + ``manifest.bak.json``: one rotating generation of the
  previous VERIFIED checkpoint, refreshed at the start of each save, so a
  torn current set rolls back to the last good one.  The port links the
  ``.bak`` names to the verified files where the JAX package copies them:
  every save replaces each primary with a new file (tmp +
  ``os.replace``), so the link keeps the previous bytes and no data moves.

The manifest's layout split is the JAX package's: ``layout`` is the
logical identity of the sampled process (facade, chains, pulsars in
logical order, padded width, thinning, stream options), ``shard_map``
the mesh the run happened to use (:func:`read_layout`).
:func:`reshard_restore` resumes a checkpoint under another mesh, and
:func:`check_layout_pulsars` refuses a model whose
pulsar order is not the checkpoint's (:class:`LayoutMismatch`).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from pathlib import Path

import numpy as np

from . import telemetry

SCHEMA_VERSION = 1
MANIFEST = "manifest.json"
MANIFEST_BAK = "manifest.bak.json"
#: checkpoint-set members covered by the manifest (when present on disk)
CHECKPOINT_FILES = ("chain.npy", "bchain.npy", "adapt.npz")


class CheckpointError(RuntimeError):
    """A checkpoint failed verification and could not be recovered."""


class LayoutMismatch(CheckpointError):
    """The checkpoint's recorded pulsar order disagrees with the model
    supplied for resume.

    The logical pulsar order is the chain identity (padded slot
    assignment and the per-pulsar rows of every draw are positional), so
    resuming against a reordered or substituted pulsar list would
    silently attribute one pulsar's state to another.  Names the first
    mismatched position (``index``/``expected``/``got``)."""

    def __init__(self, outdir, index, expected, got):
        self.index = int(index)
        self.expected = expected
        self.got = got
        self.outdir = outdir
        super().__init__(
            f"{outdir}: pulsar order mismatch at index {index}: the "
            f"checkpoint layout records {expected!r} but this PTA "
            f"supplies {got!r} — the logical pulsar order IS the chain "
            "identity (per-pulsar key folds, padded slot assignment) "
            "and cannot change on resume; reorder the PTA to the "
            "recorded layout or start a fresh run")

    def __reduce__(self):
        return (type(self), (self.outdir, self.index, self.expected,
                             self.got))


def check_layout_pulsars(outdir, want, got):
    """Raise :class:`LayoutMismatch` naming the first position where
    the checkpoint's recorded pulsar list ``want`` disagrees with the
    supplied model's ``got``.  A checkpoint with no recorded list passes
    (it is not checkable)."""
    want = [str(p) for p in (want or [])]
    got = [str(p) for p in (got or [])]
    if not want or want == got:
        return
    n = min(len(want), len(got))
    for i in range(n):
        if want[i] != got[i]:
            raise LayoutMismatch(outdir, i, want[i], got[i])
    # equal prefix, unequal length: the boundary is the first mismatch
    raise LayoutMismatch(outdir, n,
                         want[n] if len(want) > n else "<none>",
                         got[n] if len(got) > n else "<none>")


def file_sha256(path, chunk=1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            buf = fh.read(chunk)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


def _npy_meta(path):
    """(shape, dtype) of an .npy without loading the data (mmap header
    read); (None, None) when the header itself is unreadable."""
    try:
        arr = np.load(path, mmap_mode="r")
        return list(arr.shape), str(arr.dtype)
    except Exception:
        return None, None


def write_manifest(outdir, rows, extra=None) -> dict:
    """Describe the current checkpoint set in ``manifest.json`` (tmp +
    replace, so the manifest itself can never be half-written)."""
    outdir = Path(outdir)
    files = {}
    for nm in CHECKPOINT_FILES:
        p = outdir / nm
        if not p.exists():
            continue
        ent = {"sha256": file_sha256(p), "bytes": p.stat().st_size}
        if nm.endswith(".npy"):
            shape, dtype = _npy_meta(p)
            if shape is not None:
                ent["shape"], ent["dtype"] = shape, dtype
        files[nm] = ent
    man = {"schema": SCHEMA_VERSION, "rows": int(rows),
           "written_at": round(time.time(), 3), "files": files}
    if extra:
        man.update(extra)
    tmp = outdir / (MANIFEST + ".tmp")
    tmp.write_text(json.dumps(man, indent=1, sort_keys=True))
    os.replace(tmp, outdir / MANIFEST)
    return man


def read_manifest(outdir, name=MANIFEST):
    """Parsed manifest, ``None`` if absent (pre-manifest checkpoint), or
    a sentinel with ``"corrupt": True`` when present but unparseable:
    an unreadable manifest must fail verification, not resume blind."""
    p = Path(outdir) / name
    if not p.exists():
        return None
    try:
        man = json.loads(p.read_text())
    except (ValueError, OSError):
        man = None
    if not isinstance(man, dict) or "files" not in man:
        return {"schema": -1, "rows": 0, "files": {}, "corrupt": True}
    return man


def verify(outdir, manifest=None, suffix="") -> dict:
    """Check every manifest-listed file (``+ suffix``) against its
    recorded size and sha256.  Returns ``{"ok", "bad": [names],
    "rows"}``; size is checked first so the common torn case skips the
    hash."""
    outdir = Path(outdir)
    if manifest is None:
        manifest = read_manifest(outdir)
    if manifest is None:
        return {"ok": False, "bad": [MANIFEST + suffix], "rows": 0}
    if manifest.get("corrupt") or manifest.get("schema") != SCHEMA_VERSION:
        return {"ok": False, "bad": [MANIFEST + suffix], "rows": 0}
    bad = []
    for nm, ent in manifest["files"].items():
        p = outdir / (nm + suffix)
        if not p.exists() or p.stat().st_size != ent["bytes"]:
            bad.append(nm + suffix)
        elif file_sha256(p) != ent["sha256"]:
            bad.append(nm + suffix)
    return {"ok": not bad, "bad": bad,
            "rows": int(manifest.get("rows", 0))}


def read_layout(outdir):
    """The manifest's layout split, or ``None`` for a checkpoint without
    one: ``{"layout": {...}, "shard_map": {...} | None}``.  ``layout`` is
    the logical identity of the sampled process, ``shard_map`` the
    placement the run used (advisory)."""
    man = read_manifest(outdir)
    if man is None or man.get("corrupt") or "layout" not in man:
        return None
    return {"layout": man["layout"], "shard_map": man.get("shard_map")}


def reshard_restore(outdir, cm, devices=None, **gibbs_kwargs):
    """A sampler facade that resumes ``outdir``'s checkpoint under a
    (possibly different) mesh, on every rank of its world.

    The checkpoint's logical layout (chains and pulsars in logical order,
    padded pulsar width, the stream rule) pins the sampled process, the
    shard map does not: every rank draws each noise tensor at the logical
    shape and the cross-pulsar reductions run in the logical order
    (:mod:`..parallel.sharding`), so a run checkpointed under one mesh
    resumes under any other whose pulsar size divides the padded width
    and whose chain size divides the chain count, per logical chain the
    same process (bitwise where the batched library calls' bits do not
    follow the layout: ``synth_pta``'s model on the CPU).  ``devices``
    is an int (a 1-d pulsar mesh), a 2-tuple ``(n_chain_devs,
    n_pulsar_devs)`` (the 2-d mesh), or None: resume unsharded (``1``
    and ``(1, 1)`` too).  The
    ``device_count_change_on_resume`` fault, when armed, overrides
    ``devices``.  ``cm`` is the compiled model at the recorded padded
    width; ``gibbs_kwargs`` go to the facade (``device``, ``seed``, ...).
    The world (the initialized default group, or this process alone)
    must be the mesh's size: another raises :class:`CheckpointError`.  Call
    ``.sample(x0, outdir=outdir, resume=True, ...)`` on the result."""
    from . import faults

    info = read_layout(outdir)
    if info is None:
        raise CheckpointError(
            f"{outdir}: checkpoint manifest has no logical-layout "
            "section (written by a pre-elasticity version); resume it "
            "on the original device count instead")
    lay = info["layout"]
    devices = faults.device_count_override(devices)
    want = lay.get("pulsars", [])
    check_layout_pulsars(outdir, want, getattr(cm, "pulsars", []))
    pad = int(lay.get("pad_pulsars", 0)) or None
    if isinstance(devices, (tuple, list)):
        n_chain, n_psr = (int(s) for s in devices)
    else:
        n_chain, n_psr = 1, (int(devices) if devices is not None else 1)
    mesh = None
    if n_psr > 1 and (pad is None or pad % n_psr):
        raise CheckpointError(
            f"{outdir}: checkpoint's padded pulsar width ({pad}) "
            f"does not divide over {n_psr} devices; the padded "
            "width is part of the logical layout (PRNG draw shapes) "
            "and cannot be changed on resume — pick a pulsar-axis "
            "size that divides it")
    nch = int(gibbs_kwargs.get("nchains", lay.get("nchains", 1)))
    if n_chain > 1 and nch % n_chain:
        raise CheckpointError(
            f"{outdir}: checkpoint's chain count ({nch}) does not "
            f"divide over a {n_chain}-device chain axis; the chain "
            "count is part of the logical layout (per-chain key "
            "folds) and cannot be changed on resume — pick a chain-"
            "axis size that divides it")
    if pad is not None and int(cm.P) != pad:
        raise CheckpointError(
            f"{outdir}: the model is padded to {int(cm.P)} pulsars but "
            f"the checkpoint's layout records {pad}; the padded width is "
            "part of the logical layout: build the model with "
            f"pad_pulsars={pad}")
    import torch.distributed as dist

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world != n_chain * n_psr:
        # every rank of the world runs this; an unsharded facade in each
        # of several ranks would write the directory from each
        raise CheckpointError(
            f"{outdir}: reshard_restore to {n_chain * n_psr} devices "
            f"runs on every rank of a world of that size, but this "
            f"world has {world}: start {n_chain * n_psr} ranks "
            "(parallel.sharding.spawn, torchrun)")
    if n_chain * n_psr > 1:
        from ..parallel.sharding import make_mesh

        mesh = make_mesh((n_chain, n_psr) if n_chain > 1 else n_psr,
                         device=gibbs_kwargs.get("device"))
    from ..sampler.gibbs import PTABlockGibbs, PulsarBlockGibbs

    cls = {"PulsarBlockGibbs": PulsarBlockGibbs,
           "PTABlockGibbs": PTABlockGibbs}.get(
        lay.get("facade"),
        PTABlockGibbs if len(want) > 1 else PulsarBlockGibbs)
    gibbs_kwargs.setdefault("nchains", int(lay.get("nchains", 1)))
    gibbs_kwargs.setdefault("record_every", int(lay.get("record_every", 1)))
    gibbs_kwargs["mesh"] = mesh
    return cls(cm, **gibbs_kwargs)


def rotate_backup(outdir) -> bool:
    """Refresh the ``.bak`` generation from the current checkpoint set.

    Links (never moves: a kill mid-rotation must not lose the primary)
    each manifest-listed file to ``<name>.bak`` via tmp + replace, then
    the manifest to ``manifest.bak.json``; a file system without hard
    links gets copies.  Skips, leaving any existing backup untouched,
    when the current set does not verify: a torn set must never overwrite
    the last good backup.
    """
    outdir = Path(outdir)
    man = read_manifest(outdir)
    if man is None or not verify(outdir, man)["ok"]:
        return False
    for nm, bak in [(nm, nm + ".bak") for nm in man["files"]] + [
            (MANIFEST, MANIFEST_BAK)]:
        tmp = outdir / (bak + ".tmp")
        tmp.unlink(missing_ok=True)
        try:
            os.link(outdir / nm, tmp)
        except OSError:
            shutil.copy2(outdir / nm, tmp)
        os.replace(tmp, outdir / bak)
    return True


def rollback(outdir) -> bool:
    """Restore the ``.bak`` checkpoint over the primary files.

    The backup set is verified against ``manifest.bak.json`` first;
    returns False (primary untouched) when there is no verified backup.
    A restore counts ``rollbacks`` (:mod:`.telemetry`).
    """
    outdir = Path(outdir)
    bman = read_manifest(outdir, MANIFEST_BAK)
    if bman is None or not verify(outdir, bman, suffix=".bak")["ok"]:
        return False
    for nm in bman["files"]:
        tmp = outdir / (nm + ".restore.tmp")
        shutil.copy2(outdir / (nm + ".bak"), tmp)
        os.replace(tmp, outdir / nm)
    tmp = outdir / (MANIFEST + ".restore.tmp")
    shutil.copy2(outdir / MANIFEST_BAK, tmp)
    os.replace(tmp, outdir / MANIFEST)
    telemetry.incr("rollbacks")
    return True


def check_not_quarantined(outdir, force_requeue=False, manifest=None):
    """Refuse a quarantine-marked checkpoint directory unless the
    operator passed ``force_requeue``.

    A manifest whose ``serve.state`` is ``"quarantined"`` marks a job the
    serving tier parked after exhausting its quarantine budget: the
    checkpoint itself is verified (rows up to the last clean save), but
    resuming it blindly would replay the same poisoned trajectory.
    :func:`load_resume` and ``ChainStore.load_resume`` both call it, so
    no resume path skips it.  ``manifest`` skips the re-read when the
    caller already holds the manifest."""
    if force_requeue:
        return
    man = read_manifest(Path(outdir)) if manifest is None else manifest
    if (isinstance(man, dict) and not man.get("corrupt")
            and (man.get("serve") or {}).get("state") == "quarantined"):
        raise CheckpointError(
            f"{outdir} holds a QUARANTINED job (its serving tier "
            "parked it after repeated row-health breaches).  The "
            "checkpoint is verified but the job needs an operator "
            "decision: resume with force_requeue=True "
            "(--force-requeue) to requeue it from the verified rows")


def load_resume(outdir, force_requeue=False, pta=None):
    """Verified checkpoint load for a bare directory: the store is
    rebuilt from the directory's own ``pars_chain.txt`` /
    ``pars_bchain.txt`` and ``ChainStore.load_resume`` runs (manifest
    verification, ``.bak`` rollback, :class:`CheckpointError` when
    unrecoverable).  A quarantine-marked directory is refused unless
    ``force_requeue`` (:func:`check_not_quarantined`).  ``pta`` (a model,
    or anything with ``pulsars``), when given, is checked against the
    manifest's recorded pulsar order (``layout.pulsars``, or
    ``serve.pulsars`` for a serving job) before anything loads
    (:class:`LayoutMismatch`).  Returns ``(chain, bchain, start_iter,
    adapt_state)`` or ``None`` when there is nothing to resume from."""
    from ..sampler.chains import ChainStore

    outdir = Path(outdir)
    if not (outdir / "chain.npy").exists():
        return None
    if pta is not None:
        man = read_manifest(outdir)
        if isinstance(man, dict) and not man.get("corrupt"):
            want = ((man.get("layout") or {}).get("pulsars")
                    or (man.get("serve") or {}).get("pulsars"))
            if want:
                check_layout_pulsars(outdir, want,
                                     getattr(pta, "pulsars", []))

    def _names(fname):
        p = outdir / fname
        if not p.exists():
            return []
        return [ln.strip() for ln in p.read_text().splitlines()
                if ln.strip()]

    store = ChainStore(outdir, _names("pars_chain.txt"),
                       _names("pars_bchain.txt"))
    return store.load_resume(force_requeue=force_requeue)
