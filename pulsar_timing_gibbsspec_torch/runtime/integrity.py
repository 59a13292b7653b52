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


def load_resume(outdir, force_requeue=False):
    """Verified checkpoint load for a bare directory: the store is
    rebuilt from the directory's own ``pars_chain.txt`` /
    ``pars_bchain.txt`` and ``ChainStore.load_resume`` runs (manifest
    verification, ``.bak`` rollback, :class:`CheckpointError` when
    unrecoverable).  A quarantine-marked directory is refused unless
    ``force_requeue`` (:func:`check_not_quarantined`).  Returns
    ``(chain, bchain, start_iter, adapt_state)`` or ``None`` when there
    is nothing to resume from."""
    from ..sampler.chains import ChainStore

    outdir = Path(outdir)
    if not (outdir / "chain.npy").exists():
        return None

    def _names(fname):
        p = outdir / fname
        if not p.exists():
            return []
        return [ln.strip() for ln in p.read_text().splitlines()
                if ln.strip()]

    store = ChainStore(outdir, _names("pars_chain.txt"),
                       _names("pars_bchain.txt"))
    return store.load_resume(force_requeue=force_requeue)
