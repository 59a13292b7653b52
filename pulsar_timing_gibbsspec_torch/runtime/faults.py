"""Deterministic fault injection for the port's chaos tests.

The port's copy of the part of ``pulsar_timing_gibbsspec_tpu/runtime/
faults.py`` that a supervised run and the serving tier reach.
Production code calls the seam hooks (:func:`fire`, :func:`mutate_rows`,
:func:`tenant_evict_request`, :func:`poison_tenant_rows`); with nothing
armed they are one list check.  Tests arm faults with :func:`inject` and the
hooks then raise or corrupt deterministically at the requested row.

Seams (``fire``):

- ``"chainstore.between_replaces"``: in ``ChainStore.save``, after
  ``chain.npy`` was replaced and before ``bchain.npy`` (the torn
  checkpoint window); ``row`` is the checkpoint's row count.
- ``"chainstore.post_save"``: after the whole set, ``manifest.json``
  included, is on disk (the file-damage kinds act here).
- ``"sample.loop"``: in the facade's loop, after the new rows passed the
  sentinels; ``row`` is the rows done so far.
- ``"dispatch.chunk"``: in the driver's chunk loop, under the dispatch
  watchdog, once the chunk starting at iteration ``row`` is queued and
  before the host waits for the chunk before it.
- ``"serve.chunk"``: in the service's scheduler loop, between
  multiplexed chunks; ``row`` is the service's global chunk counter.
  The service also polls :func:`tenant_evict_request` there.

Kinds:

- ``"crash"``: raise :class:`InjectedCrash` (a kill at that statement).
- ``"xla_error"``: raise :class:`InjectedDeviceError`, the stand-in for
  a CUDA runtime error; the supervisor puts it in the ``device`` class,
  as it does a real one.  The JAX package's name is kept so that both
  chaos suites read alike.
- ``"nan_rows"``: overwrite the recorded chain/bchain row ``at_row``
  with NaN through :func:`mutate_rows` (a diverged chunk's output).
- ``"truncate_file"``: cut the target file (``path``, default
  ``chain.npy``) to half its size at a seam with ``outdir``.
- ``"corrupt_file"``: overwrite a few bytes in the middle of it.
- ``"sigterm_at_seam"``: request a preemption drain at the seam (the
  signal handler calls the same ``preemption.request_drain``);
  ``seconds`` is the drain deadline (the default when 0).
- ``"stall"``: sleep ``seconds`` at the seam (a hung device, as the host
  sees it); at ``"dispatch.chunk"`` the watchdog's deadline runs.
- ``"tenant_evict"``: make :func:`tenant_evict_request` return truthy at
  ``"serve.chunk"``: the service checkpoints a resident and requeues it.
  With ``tenant=<id>`` the fault names its victim and ``at_row`` counts
  that job's resident chunks, not the global chunk counter.
- ``"poison_rows"``: NaN-poison one tenant's rows of a multiplexed chunk
  through :func:`poison_tenant_rows` (a single tenant's divergence, the
  quarantine drill's trigger); ``tenant`` names the victim, ``at_row``
  counts its resident chunks.
- ``"device_loss"``: raise :class:`DeviceLost` at the seam, carrying
  ``devices``, the surviving device count (and ``slice``, the placement
  slice it is attributed to, when given).
- ``"device_count_change_on_resume"``: make :func:`device_count_override`
  return ``devices``: the pool handing the next incarnation another
  device count than the checkpoint was written under
  (``integrity.reshard_restore`` consults it).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

import numpy as np


class InjectedCrash(RuntimeError):
    """A simulated hard kill (e.g. between checkpoint replaces)."""


class InjectedDeviceError(RuntimeError):
    """The stand-in for a CUDA runtime error (``torch.AcceleratorError``,
    a cuBLAS or cuSOLVER failure): ``classify_failure`` puts it in the
    ``device`` class."""


class DeviceLost(RuntimeError):
    """A device dropped out of the mesh mid-run.

    Unlike a transient :class:`InjectedDeviceError`, the lost capacity
    does not come back on retry: the run must evacuate (drain state
    through verified checkpoints, rebuild on the surviving devices,
    ``devices`` or None when unknown, and resume there with
    ``integrity.reshard_restore``).  ``slice_id`` attributes the loss to
    one placement slice of a multi-slice service; None: the whole
    run."""

    def __init__(self, msg, devices=None, slice_id=None):
        super().__init__(msg)
        self.devices = devices
        self.slice_id = slice_id

    def __reduce__(self):
        # a rank re-raises the writer's exception from its pickle
        return (type(self), (str(self), self.devices, self.slice_id))


@dataclass
class _Fault:
    kind: str
    point: str | None = None    # required seam, None = any seam
    at_row: int | None = None   # fire once row >= at_row
    times: int = 1              # firings before the fault disarms
    backend: str | None = None  # fire for this backend name only
    path: str | None = None     # target file of the file-damage kinds
    seconds: float = 0.0        # stall sleep / drain deadline
    devices: int | None = None  # device_count override / survivors
    tenant: int | None = None   # victim tenant of the serving kinds
    slice: int | None = None    # victim placement slice (device_loss)
    fired: int = 0


_armed: list[_Fault] = []
_lock = threading.Lock()


def inject(kind, point=None, at_row=None, times=1, backend=None, path=None,
           seconds=0.0, devices=None, tenant=None, slice=None):
    """Arm a fault; returns its handle (removed by :func:`clear`)."""
    f = _Fault(kind=kind, point=point, at_row=at_row, times=times,
               backend=backend, path=path, seconds=seconds, devices=devices,
               tenant=tenant, slice=slice)
    with _lock:
        _armed.append(f)
    return f


def clear() -> None:
    """Disarm every fault."""
    with _lock:
        _armed.clear()


def _take(point, row, backend, kinds):
    """The armed faults of ``kinds`` matching (point, row, backend), each
    consuming one firing; a row-triggered fault fires at the first seam
    whose row reaches ``at_row``."""
    hits = []
    with _lock:
        for f in _armed:
            if f.kind not in kinds or f.fired >= f.times:
                continue
            if f.point is not None and f.point != point:
                continue
            if f.at_row is not None and (row is None or row < f.at_row):
                continue
            if (f.backend is not None and backend is not None
                    and f.backend != backend):
                continue
            f.fired += 1
            hits.append(f)
    return hits


def fire(point, row=None, backend=None, outdir=None):
    """Seam hook: damage files, stall, request a drain or raise, as the
    armed faults say.  One truthiness check when nothing is armed."""
    if not _armed:
        return
    for f in _take(point, row, backend, ("truncate_file", "corrupt_file")):
        if outdir is not None:
            _damage(os.path.join(str(outdir), f.path or "chain.npy"), f.kind)
    for f in _take(point, row, backend, ("stall",)):
        time.sleep(f.seconds)
    for f in _take(point, row, backend, ("sigterm_at_seam",)):
        from . import preemption

        preemption.request_drain(reason=f"sigterm_at_seam:{point}",
                                 deadline_s=f.seconds or None)
    for f in _take(point, row, backend, ("crash", "xla_error",
                                         "device_loss")):
        if f.kind == "crash":
            raise InjectedCrash(f"injected crash at {point} (row {row})")
        if f.kind == "device_loss":
            where = "" if f.slice is None else f" on slice {f.slice}"
            raise DeviceLost(
                f"injected device loss{where} at {point} (row {row}): "
                f"{f.devices if f.devices is not None else '?'} "
                "device(s) survive", devices=f.devices, slice_id=f.slice)
        raise InjectedDeviceError(
            f"CUDA error: injected device failure at {point} (row {row})")


def device_count_override(default=None):
    """Consume an armed ``device_count_change_on_resume`` fault: its
    ``devices`` (counting a firing), or ``default`` when none is armed.
    Resume paths call it to learn the device count the pool hands the
    next incarnation."""
    if not _armed:
        return default
    hits = _take("resume.device_count", None, None,
                 ("device_count_change_on_resume",))
    return hits[-1].devices if hits else default


def _damage(path, kind):
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        if kind == "truncate_file":
            fh.truncate(max(size // 2, 1))
        else:                   # corrupt_file: bytes past the header
            fh.seek(max(size // 2, 0))
            fh.write(b"\xde\xad\xbe\xef")


def mutate_rows(chain, bchain, lo, hi, backend=None):
    """NaN-poison recorded row ``at_row`` in ``[lo, hi)`` for the armed
    ``nan_rows`` faults (a diverged chunk landing in the host record)."""
    if not _armed:
        return
    with _lock:
        hits = [f for f in _armed
                if f.kind == "nan_rows" and f.fired < f.times
                and f.at_row is not None and lo <= f.at_row < hi
                and (f.backend is None or backend is None
                     or f.backend == backend)]
        for f in hits:
            f.fired += 1
    for f in hits:
        chain[f.at_row] = np.nan
        bchain[f.at_row] = np.nan


def tenant_evict_request(row=None, job_rows=None):
    """Consume armed ``tenant_evict`` faults at the ``serve.chunk``
    seam (counting a firing each).

    ``row`` is the service's global chunk counter; ``job_rows`` maps
    resident ``tenant_id -> chunks that tenant has been resident``
    (the service passes it so ``at_row`` on a tenant-targeted fault
    counts the VICTIM's chunks, not everyone's — a global counter
    cannot say "evict tenant 2 after its 3rd chunk" when admission
    order varies).  Returns the set of victim tenant_ids, or ``True``
    for an untargeted request (evict any one resident — historical
    behavior), or ``False`` when nothing fired.
    """
    if not _armed:
        return False
    victims = set()
    untargeted = False
    with _lock:
        for f in _armed:
            if f.kind != "tenant_evict" or f.fired >= f.times:
                continue
            if f.point is not None and f.point != "serve.chunk":
                continue
            if f.tenant is not None:
                held = None if job_rows is None \
                    else job_rows.get(int(f.tenant))
                if held is None or (f.at_row is not None
                                    and held < f.at_row):
                    continue
                f.fired += 1
                victims.add(int(f.tenant))
            else:
                if f.at_row is not None and (row is None
                                             or row < f.at_row):
                    continue
                f.fired += 1
                untargeted = True
    if victims:
        return victims
    return untargeted


def poison_tenant_rows(np_xs, np_bs, tenant_slots, job_rows):
    """NaN-poison ONE tenant's rows of a multiplexed chunk for armed
    ``poison_rows`` faults (the blast-radius drill: a single tenant's
    chunk output diverges while its co-residents' rows stay exact).

    ``np_xs`` (chunk, T, nx) / ``np_bs`` (chunk, T, ...) are the host
    copies of the recorded stacks; ``tenant_slots`` maps tenant_id ->
    slot index; ``job_rows`` maps tenant_id -> chunks resident (the
    per-job ``at_row`` clock, same as :func:`tenant_evict_request`).
    Returns ``(np_xs, np_bs, poisoned_slots)`` — the arrays are copied
    first when read-only (``np.asarray`` of a device array is an
    immutable view), so callers must rebind them.
    """
    if not _armed:
        return np_xs, np_bs, set()
    poisoned = set()
    with _lock:
        for f in _armed:
            if f.kind != "poison_rows" or f.fired >= f.times:
                continue
            if f.tenant is None:
                continue
            slot = tenant_slots.get(int(f.tenant))
            if slot is None:
                continue
            held = job_rows.get(int(f.tenant), 0)
            if f.at_row is not None and held < f.at_row:
                continue
            f.fired += 1
            poisoned.add(int(slot))
    if poisoned:
        if not np_xs.flags.writeable:
            np_xs = np_xs.copy()
        if not np_bs.flags.writeable:
            np_bs = np_bs.copy()
        for slot in poisoned:
            np_xs[:, slot] = np.nan
            np_bs[:, slot] = np.nan
    return np_xs, np_bs, poisoned
