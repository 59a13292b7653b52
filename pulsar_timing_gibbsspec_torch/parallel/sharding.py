"""Pulsar-axis sharding of the compiled model over a mesh of ranks.

The port's copy of ``pulsar_timing_gibbsspec_tpu/parallel/sharding.py``
on ``torch.distributed``.  The JAX package runs one controller over a
device mesh and lets XLA insert the collectives; PyTorch runs one process
per rank, so the port says where each collective goes:

- A :class:`Mesh` is a grid of global ranks with the axis names
  ``("pulsar",)`` or ``("chain", "pulsar")``, built by :func:`make_mesh`
  on an initialized default group whose world it covers exactly.  Each
  rank holds the process groups of its row (the pulsar group) and column
  (the chain group) and a gloo group over the world for host data.
- :func:`shard_compiled` keeps this rank's rows of every pulsar-axis
  field of the compiled model (:data:`_PULSAR_FIELDS`); every other
  field stays whole on every rank.  The model keeps its logical padded
  width ``P`` and ``P_real`` and gains the shard's first row ``p0`` and
  row count ``pn``.
- A sweep's cross-pulsar reductions go through :func:`gather_pulsars`:
  every rank all-gathers the small per-pulsar terms along its pulsar
  group and reduces them in the logical pulsar order, so a reduction
  gives the same bits under every layout.  A chain's bits then follow
  the layout only where a batched library call's do (on the CPU,
  ATen's elementwise kernels round by position; on the card, the exact
  b-draw's plain float64 factor moves with the batch count).  A block
  that writes per-pulsar slots of ``x`` ends with :func:`sync_x`, which
  gathers them, so ``x`` is the same on every rank of a pulsar group
  after each block.
- Chains split over the chain axis and never talk in a sweep.  Every
  rank draws each noise tensor at its full logical ``(C, P, ...)`` shape
  and keeps its own rows (:func:`draw`): the streams are the unsharded
  run's.
- Host data (chunk records, adaptation records, the writer's save
  outcome) goes over the gloo group: :meth:`Mesh.assemble`,
  :meth:`Mesh.broadcast_object`.

Every group is made with :data:`PROCESS_GROUP_TIMEOUT` (300 s).
A collective waits at most that long: a rank that fails alone leaves
the others in a collective until it expires, and they then raise.
:func:`spawn` starts the ranks of one host with ``torch.multiprocessing``
and a ``FileStore``; under ``torchrun`` call :func:`init_from_env`.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist

#: CompiledPTA fields whose leading axis is the pulsar axis (the JAX
#: package's list, on the port's names)
_PULSAR_FIELDS = (
    "y", "T", "toa_mask", "psr_mask", "sigma2", "efac_ix", "equad_ix",
    "gequad_ix", "phi_base", "gp_mask", "gw_sin_ix", "gw_cos_ix", "gw_f",
    "gw_df", "gw_hyp_ix", "gw_rho_ix", "red_valid", "red_hyp_ix",
    "red_rho_ix", "red_rho_ix_x", "red_sin_ix", "red_cos_ix", "red_f",
    "red_df", "ec_cols", "ec_ix", "ke_eid", "ke_par_ix", "ke_U",
    "white_par_ix", "white_nper", "ecorr_par_ix", "ecorr_nper",
)
#: the per-pulsar tables of x slots: the slots :func:`sync_x` takes from
#: the rank that owns their pulsar
_X_SLOT_FIELDS = ("white_par_ix", "ecorr_par_ix", "red_rho_ix_x")
#: how long a collective waits for a rank
PROCESS_GROUP_TIMEOUT = datetime.timedelta(seconds=300)

#: collectives issued through this module since :func:`reset_collectives`
#: (``all_gather``, ``broadcast``, ``host_gather``) and the bytes the
#: device gathers received (``gather_bytes``)
COLLECTIVES = collections.Counter()


def reset_collectives():
    COLLECTIVES.clear()


class Mesh:
    """A grid of global ranks: ``devices`` (the grid, as the JAX mesh's
    ``devices``), ``axis_names``, this process's ``rank`` and ``device``,
    its ``pulsar_group`` (its row) and ``chain_group`` (its column) with
    its positions ``pulsar_index`` / ``chain_index`` along them, and the
    world's gloo ``host_group``.  Build it with :func:`make_mesh`."""

    def __init__(self, shape, axis_names, device=None):
        world, rank = dist.get_world_size(), dist.get_rank()
        self.devices = np.arange(world).reshape(shape)
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.backend = str(dist.get_backend())
        self.device = torch.device(
            device if device is not None
            else ("cuda" if self.backend == "nccl" else "cpu"))
        grid = self.devices.reshape(-1, shape[-1])
        # every rank makes every group, in one order
        for row in grid:
            g = dist.new_group(row.tolist(), timeout=PROCESS_GROUP_TIMEOUT)
            if rank in row:
                self.pulsar_group = g
        for col in grid.T:
            g = dist.new_group(col.tolist(), timeout=PROCESS_GROUP_TIMEOUT)
            if rank in col:
                self.chain_group = g
        self.host_group = (
            None if self.backend == "gloo" else
            dist.new_group(backend="gloo", timeout=PROCESS_GROUP_TIMEOUT))
        self.chain_index, self.pulsar_index = (
            int(v) for v in np.argwhere(grid == rank)[0])

    @property
    def size(self):
        return int(self.devices.size)

    def group_backend(self, group):
        return str(dist.get_backend(group))

    def broadcast_object(self, obj, src=0):
        """``obj`` of global rank ``src`` on every rank (pickled, over the
        host group)."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.host_group)
        COLLECTIVES["broadcast"] += 1
        return box[0]

    def all_gather_object(self, obj):
        """Every rank's ``obj``, in global rank order."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.host_group)
        COLLECTIVES["host_gather"] += 1
        return out

    def assemble(self, local, c_axis=None, p_axis=None):
        """The logical array from every rank's block ``local`` (numpy):
        blocks of one pulsar group are concatenated along ``p_axis``
        (None: they are replicas, the first is taken), then the chain
        groups along ``c_axis`` (None: replicas).  Every rank gets it.
        Replicas that differ raise ``RuntimeError``: the ranks of a
        pulsar group must hold the same ``x`` bit for bit."""
        blocks = self.all_gather_object(np.asarray(local))
        grid = self.devices.reshape(-1, self.devices.shape[-1])
        if p_axis is None:
            for row in grid:
                if any(not np.array_equal(blocks[r], blocks[row[0]],
                                          equal_nan=True) for r in row):
                    raise RuntimeError(
                        f"ranks {row.tolist()} of a pulsar group hold "
                        "different replicas of a replicated array (x)")
        rows = [np.concatenate([blocks[r] for r in row], axis=p_axis)
                if p_axis is not None else blocks[row[0]] for row in grid]
        return (np.concatenate(rows, axis=c_axis) if c_axis is not None
                else rows[0])


def make_mesh(n_devices=None, axis: str = "pulsar", device=None):
    """A mesh of the default group's ranks: 1-d over the pulsar axis
    (``n_devices`` an int, or None for the whole world), or 2-d
    ``(chain, pulsar)`` for a 2-tuple ``(n_chain_devs, n_pulsar_devs)``;
    global rank ``r`` sits at ``divmod(r, n_pulsar_devs)``.  Chains are
    independent Gibbs processes, so the chain axis carries no collective
    in a sweep.  ``device`` is this rank's device (default: ``cuda``
    under NCCL, else ``cpu``).  Every rank of the world calls it, in the
    same order; it raises when the world is not the mesh's size, which
    would leave ranks outside every collective (or build a truncated
    mesh)."""
    shape = None
    if isinstance(n_devices, (tuple, list, np.ndarray)):
        shape = tuple(int(s) for s in n_devices)
        if len(shape) != 2 or any(s < 1 for s in shape):
            raise ValueError(
                f"make_mesh expects (n_chain_devs, n_pulsar_devs), "
                f"got {n_devices!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed default "
            "group: start the ranks with parallel.sharding.spawn, or under "
            "torchrun call parallel.sharding.init_from_env()")
    world = dist.get_world_size()

    def _need(n):
        if world != n:
            raise RuntimeError(
                f"make_mesh({n_devices}) but the world has {world} "
                f"rank(s); refusing to build a truncated mesh (every rank "
                "of the world must sit in it): start the run with a world "
                f"of {n} ranks")

    if shape is not None:
        _need(shape[0] * shape[1])
        return Mesh(shape, ("chain", axis), device)
    n = world if n_devices is None else int(n_devices)
    _need(n)
    return Mesh((n,), (axis,), device)


def pulsar_submesh_size(mesh) -> int:
    """Ranks along the mesh's pulsar axis (the last axis)."""
    return int(mesh.devices.shape[-1])


def chain_submesh_size(mesh) -> int:
    """Ranks along the mesh's chain axis; 1 without one."""
    if mesh is None or "chain" not in mesh.axis_names:
        return 1
    return int(mesh.devices.shape[list(mesh.axis_names).index("chain")])


def chain_slice(mesh, lo: int, hi: int):
    """Chain-axis rows ``[lo, hi)`` of a 2-d mesh as the grid of global
    ranks they hold, ``(hi - lo, n_pulsar)``: the slice-carving primitive
    of the JAX serving placement.  The port's service takes no placement
    yet (ROADMAP A.15), so a slice is a description, not a mesh with
    groups of its own."""
    if mesh is None:
        return None
    if "chain" not in mesh.axis_names:
        raise ValueError(
            "chain_slice needs a 2-d (chain, pulsar) mesh; got axes "
            f"{tuple(mesh.axis_names)} — build one with "
            "make_mesh((n_chain, n_pulsar))")
    nc = chain_submesh_size(mesh)
    lo, hi = int(lo), int(hi)
    if not 0 <= lo < hi <= nc:
        raise ValueError(
            f"chain_slice rows [{lo}, {hi}) fall outside the mesh's "
            f"chain axis ({nc} rows, mesh {tuple(mesh.devices.shape)})")
    return mesh.devices[lo:hi]


def carve_chain_slices(mesh, spans):
    """Consecutive chain-row spans (row counts) as disjoint slices
    (:func:`chain_slice`), in order from row 0; raises when they overrun
    the chain axis."""
    out = []
    lo = 0
    nc = chain_submesh_size(mesh)
    for c in spans:
        c = int(c)
        if lo + c > nc:
            raise ValueError(
                f"carve_chain_slices: spans {list(spans)} need "
                f"{lo + c} chain rows but the mesh has {nc}")
        out.append(chain_slice(mesh, lo, lo + c))
        lo += c
    return out


def mesh_layout(mesh):
    """JSON description of a mesh placement: the manifest's ``shard_map``
    section (the JAX package's keys; ``platform`` is the ranks' device
    type).  Advisory: ``integrity.reshard_restore`` may resume under any
    mesh whose pulsar size divides the padded width and whose chain size
    divides the chain count."""
    if mesh is None:
        return None
    return {"devices": mesh.size,
            "axis": str(mesh.axis_names[-1]),
            "axes": [[str(n), int(s)]
                     for n, s in zip(mesh.axis_names, mesh.devices.shape)],
            "platform": mesh.device.type}


def validate_chains(mesh, nchains: int):
    """Raise unless ``nchains`` splits evenly over the mesh's chain
    axis (the JAX package's words)."""
    nc = chain_submesh_size(mesh)
    if nc > 1 and int(nchains) % nc:
        raise ValueError(
            f"nchains={int(nchains)} does not divide over the mesh's "
            f"chain axis ({nc} devices, mesh "
            f"{tuple(mesh.devices.shape)}); pass nchains as a multiple "
            f"of {nc} (e.g. nchains={-(-int(nchains) // nc) * nc}) or "
            f"shrink the chain axis with make_mesh((n_chain, n_pulsar))")


def chain_rows(mesh, nchains):
    """``(c0, cn)``: this rank's first chain and chain count."""
    nc = chain_submesh_size(mesh)
    cn = int(nchains) // nc
    return (mesh.chain_index if nc > 1 else 0) * cn, cn


def shard_carry(mesh, tree, nchains: int):
    """This rank's chains of a carry: every array leaf (tensor or numpy)
    whose leading axis is ``nchains`` keeps its rows of the chain axis;
    other leaves are replicated as they are.  A mesh without a chain
    axis (or None) returns the tree untouched."""
    if mesh is None or "chain" not in mesh.axis_names:
        return tree
    c0, cn = chain_rows(mesh, nchains)

    def place(leaf):
        if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == int(nchains):
            return leaf[c0:c0 + cn]
        return leaf

    if isinstance(tree, dict):
        return {k: shard_carry(mesh, v, nchains) if isinstance(v, dict)
                else place(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v) for v in tree)
    return place(tree)


@dataclasses.dataclass
class Shard:
    """What a sharded model carries: its mesh, the logical padded width
    ``P`` and chain count ``C``, this rank's rows ``[p0, p0 + pn)`` and
    chains ``[c0, c0 + cn)`` (``C`` 0 until a driver sets them), and the
    pulsar-group index owning each x slot (``owner``, (nx,))."""

    mesh: Mesh
    P: int
    p0: int
    pn: int
    owner: torch.Tensor
    C: int = 0
    c0: int = 0
    cn: int = 0

    def with_chains(self, nchains):
        c0, cn = chain_rows(self.mesh, nchains)
        return dataclasses.replace(self, C=int(nchains), c0=c0, cn=cn)


def shard_compiled(cm, mesh):
    """This rank's shard of ``cm``: its rows of every pulsar-axis field
    (contiguous copies), the rest as it is, and the shard's :class:`Shard`
    as ``cm.shard``.  Raises the JAX package's ``pad_pulsars=``
    suggestion when the padded width does not divide over the pulsar
    axis."""
    from ..sampler.compiled import GPComponent

    n = pulsar_submesh_size(mesh)
    if cm.P % n:
        total = mesh.size
        where = (f"the pulsar submesh ({n} of {total} devices, mesh "
                 f"{tuple(mesh.devices.shape)})" if total != n
                 else f"the mesh ({n} devices)")
        raise ValueError(
            f"pulsar axis ({cm.P}) does not divide {where}; "
            f"compile with pad_pulsars={-(-cm.P // n) * n}")
    pn = cm.P // n
    p0 = mesh.pulsar_index * pn

    def rows(t):
        return None if t is None else t[p0:p0 + pn].contiguous()

    updates = {name: rows(getattr(cm, name)) for name in _PULSAR_FIELDS
               if getattr(cm, name) is not None}
    updates["components"] = [
        GPComponent(c.kind, *(rows(getattr(c, k)) for k in
                              ("cols", "rho_ix", "f", "df", "hyp_ix")))
        for c in cm.components]
    owner = torch.zeros(cm.nx + 1, dtype=torch.int64)
    for name in _X_SLOT_FIELDS:
        ix = getattr(cm, name).cpu()
        for p in range(cm.P):
            owner[ix[p]] = p // pn
    owner = owner[:cm.nx].to(cm.device)
    updates.update(p0=p0, pn=pn,
                   shard=Shard(mesh=mesh, P=cm.P, p0=p0, pn=pn, owner=owner))
    return dataclasses.replace(cm, **updates)


# ---------------------------------------------------------------------------
# the sweep's collectives


def _gather_into(t, group, backend):
    """(n, *t.shape): ``t`` of every rank of ``group``, in group order.
    A gloo group gathers CUDA tensors through the host."""
    n = dist.get_world_size(group)
    src = t.detach()
    if backend == "gloo" and src.device.type != "cpu":
        src = src.cpu()
    src = src.contiguous()
    shape = tuple(src.shape)
    out = torch.empty((n * shape[0],) + shape[1:], dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["gather_bytes"] += out.numel() * out.element_size()
    return out.view((n,) + shape).to(t.device)


def gather_pulsars(shard, t, dim):
    """The logical tensor of every rank's per-pulsar block ``t``,
    concatenated along the pulsar axis ``dim`` in the logical pulsar
    order; ``t`` itself without a shard."""
    if shard is None:
        return t
    grp = shard.mesh.pulsar_group
    out = _gather_into(t, grp, shard.mesh.group_backend(grp))
    return torch.cat(out.unbind(0), dim=dim % t.dim())


def sync_x(shard, x):
    """``x`` (..., nx) with every per-pulsar slot taken from the rank
    that owns its pulsar (the shared slots from the group's first rank):
    after a block that wrote its own pulsars' slots, the same bits on
    every rank of the pulsar group.  ``x`` itself without a shard."""
    if shard is None:
        return x
    grp = shard.mesh.pulsar_group
    g = _gather_into(x, grp, shard.mesh.group_backend(grp))
    ix = shard.owner.expand((1,) + tuple(x.shape))
    return torch.gather(g, 0, ix)[0]


def draw(shard, fn, shape, c_axis=None, p_axis=None):
    """``fn(shape)`` at the logical shape, this rank's chains (axis
    ``c_axis``) and pulsars (axis ``p_axis``) kept: ``shape`` is the
    local shape.  ``fn`` must be elementwise in its draw (a generator
    call at that shape), so that the kept rows are the unsharded run's."""
    if shard is None:
        return fn(tuple(shape))
    full = list(shape)
    cuts = []
    if c_axis is not None and shard.C:
        full[c_axis] = shard.C
        cuts.append((c_axis, shard.c0, shard.cn))
    if p_axis is not None:
        full[p_axis] = shard.P
        cuts.append((p_axis, shard.p0, shard.pn))
    out = fn(tuple(full))
    for ax, lo, n in cuts:
        out = out.narrow(ax, lo, n)
    return out.contiguous() if cuts else out


def collective_report(fn, *args):
    """Run ``fn(*args)`` and count the collectives it issued through this
    module: ``{"all_gather": n, "broadcast": n, "host_gather": n,
    "gather_bytes": bytes}`` (the port's stand-in for the JAX package's
    HLO census).  Returns ``(fn's result, counts)``."""
    before = collections.Counter(COLLECTIVES)
    out = fn(*args)
    after = collections.Counter(COLLECTIVES)
    keys = ("all_gather", "broadcast", "host_gather", "gather_bytes")
    return out, {k: after[k] - before[k] for k in keys}


# ---------------------------------------------------------------------------
# starting ranks


def init_from_env(backend=None):
    """Initialize the default group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``):
    ``backend`` NCCL when a card is present, else gloo; with NCCL the
    rank takes card ``LOCAL_RANK``.  Returns the rank's device."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    device = torch.device("cpu")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    dist.init_process_group(backend, timeout=PROCESS_GROUP_TIMEOUT)
    return device


def _child(rank, fn, world, backend, device, store_path, out_dir, args):
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=PROCESS_GROUP_TIMEOUT)
    try:
        out = fn(rank, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def spawn(fn, world, backend="gloo", device="cpu", args=()):
    """Run ``fn(rank, *args)`` in ``world`` new processes of this host,
    each a rank of a default group (``backend``, a ``FileStore`` in a
    fresh temporary directory) on ``device`` (the ranks may share one
    card under gloo).  ``fn`` must be importable by module name (a
    spawned child imports its module).  Returns the ranks' results in
    rank order; a rank that raises ends the others and raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ptg_spawn_") as tmp:
        mp.start_processes(
            _child, args=(fn, int(world), backend, str(device),
                          os.path.join(tmp, "store"), tmp, tuple(args)),
            nprocs=int(world), join=True, start_method="spawn")
        out = []
        for r in range(int(world)):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
    return out
