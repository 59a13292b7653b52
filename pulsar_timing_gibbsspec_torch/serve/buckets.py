"""Bucketed padding: snap any dataset to a small table of compiled shapes.

The port's copy of ``pulsar_timing_gibbsspec_tpu/serve/buckets.py``;
:func:`probe_shape` reads the port's model arrays.

A captured sweep is a function of the padded array geometry
``(P_pad, TOA_pad, B_pad, K)`` — pulsar axis, TOA axis, basis axis,
common-process frequency count.  Capturing per dataset means a cold
CUDA-graph capture per request; capturing per *bucket* means a handful
of graphs total, each captured once, with every request snapped up to
the smallest covering bucket.  The padding is exact, not approximate: pad
TOA rows carry ``y=0, T=0, sigma2=1`` with constant ``efac=1`` /
``equad=-40`` (unit Nvec, zero masked log-likelihood), pad basis
columns carry ``phi_base=1`` with ``basis_mask=0``, and pad pulsars are
fully inert (``sampler/compiled.py`` conventions) — so a dataset run in
a larger bucket samples the identical posterior.

The first three axes pad; ``K`` does not.  The frequency count is
structural (it sets the rho-block parameter count and the Fourier
basis), so a bucket only covers datasets with exactly its ``modes``.

Routing never over-pads silently and never reaches
``model_arrays``'s shape errors: a dataset beyond the largest covering
shape raises a typed :class:`BucketOverflow` carrying the nearest
bucket so the caller can renegotiate (split the dataset, or provision
a bigger table) instead of crashing mid-compile.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One compiled-program shape: pad targets per axis + exact mode
    count.  Hashable (dict key of the program cache)."""

    pulsars: int    # padded pulsar-axis length (model_arrays pad_pulsars)
    toas: int       # padded TOA axis (model_arrays pad_toas -> Nmax)
    basis: int      # padded basis axis (model_arrays pad_basis -> Bmax)
    modes: int      # common-process frequency count K (exact match)

    def covers(self, shape: "DatasetShape") -> bool:
        return (self.pulsars >= shape.pulsars and self.toas >= shape.toas
                and self.basis >= shape.basis
                and self.modes == shape.modes)

    def cost(self) -> int:
        """Padded element count of the dominant (P, Nmax, Bmax) basis
        tensor — the 'smallest covering bucket' ordering."""
        return self.pulsars * self.toas * self.basis

    def as_tuple(self):
        return (self.pulsars, self.toas, self.basis, self.modes)


@dataclasses.dataclass(frozen=True)
class DatasetShape:
    """The routed quantities of one dataset (see :func:`probe_shape`)."""

    pulsars: int    # real pulsar count
    toas: int       # largest per-pulsar TOA count
    basis: int      # widest per-pulsar basis
    modes: int      # common free-spectrum frequency count


class BucketOverflow(ValueError):
    """No bucket covers the dataset.

    Carries the offending ``shape`` (:class:`DatasetShape`) and the
    ``nearest`` bucket — the largest-capacity bucket with the right
    mode count (or the largest overall when no bucket matches the mode
    count) — so callers can report exactly which axis overflowed and by
    how much instead of dying inside ``pad_pulsars``/``model_arrays``.
    """

    def __init__(self, shape: DatasetShape, nearest: BucketSpec | None):
        self.shape = shape
        self.nearest = nearest
        self.hint = next_covering(shape, base=nearest)
        near = (f"nearest bucket {nearest.as_tuple()}"
                if nearest is not None else "empty table")
        super().__init__(
            f"dataset shape (P={shape.pulsars}, TOA={shape.toas}, "
            f"B={shape.basis}, K={shape.modes}) exceeds every bucket; "
            f"{near}; migration hint: provision a covering bucket like "
            f"{self.hint.as_tuple()}")


def next_covering(shape: DatasetShape, base: BucketSpec | None = None
                  ) -> BucketSpec:
    """The planner's proposal for a bucket covering ``shape``: start
    from ``base`` (the nearest existing bucket, when any) and double
    each overflowing padded axis until it covers — the same doubling
    discipline as :meth:`BucketTable.ladder`, so provisioned buckets
    stay on the ladder instead of proliferating one-off shapes.  The
    mode count is structural and copied exactly."""
    p = int(base.pulsars) if base is not None else 1
    t = int(base.toas) if base is not None else 1
    b = int(base.basis) if base is not None else 1
    while p < shape.pulsars:
        p *= 2
    while t < shape.toas:
        t *= 2
    while b < shape.basis:
        b *= 2
    return BucketSpec(p, t, b, int(shape.modes))


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """The migration planner's answer for a grown dataset (see
    :func:`plan_migration`).

    ``kind`` is ``"in_place"`` when the parent's bucket still covers
    the grown shape — the compiled program, padded widths, and hence
    the retained-row prefix are unchanged (bitwise contract) — or
    ``"rebucket"`` when the grown shape needs the next covering bucket
    and the checkpoint's padded-basis axes must be re-embedded
    (zero-padded) into the child bucket's geometry."""

    kind: str                   # "in_place" | "rebucket"
    parent_bucket: BucketSpec
    child_bucket: BucketSpec
    shape: DatasetShape

    @property
    def in_place(self) -> bool:
        return self.kind == "in_place"


def plan_migration(table: "BucketTable", parent_bucket: BucketSpec,
                   shape: DatasetShape) -> MigrationPlan:
    """Plan the bucket migration for a dataset grown to ``shape``
    while standing in ``parent_bucket``.

    In-place when the parent bucket still covers the grown shape
    (appends that stay under the padded TOA/basis headroom); otherwise
    routes the grown shape through ``table`` for the next covering
    bucket — raising the table's typed :class:`BucketOverflow` (hint
    attached) when nothing covers.  A mode-count change is structural
    (different parameter space), not a migration: typed refusal."""
    if shape.modes != parent_bucket.modes:
        raise ValueError(
            f"append cannot change the common-process mode count "
            f"(parent bucket K={parent_bucket.modes}, grown dataset "
            f"K={shape.modes}) — a mode change is a new model, not a "
            "migration; submit a fresh job")
    if shape.pulsars > parent_bucket.pulsars:
        # more REAL pulsars means more parameters: the chain prefix
        # would not even be the same vector.  Growing the pulsar set is
        # a new model; only the TOA/basis axes of existing pulsars may
        # grow under a migration.
        raise ValueError(
            f"append cannot add pulsars ({shape.pulsars} > parent "
            f"bucket's {parent_bucket.pulsars}) — the parameter space "
            "changes; submit a fresh job for the extended array")
    if parent_bucket.covers(shape):
        return MigrationPlan("in_place", parent_bucket, parent_bucket,
                             shape)
    child = table.route(shape)      # BucketOverflow propagates, typed
    return MigrationPlan("rebucket", parent_bucket, child, shape)


def probe_shape(arrays) -> DatasetShape:
    """Measure the routed quantities of a dataset's model arrays (the
    unpadded ``models.build.model_arrays`` dict; a :class:`~.engine.
    Dataset` or a compiled model gives its own): real pulsar count,
    largest TOA count, widest basis, and the common free-spectrum
    frequency count (the rho-block size)."""
    from ..sampler.compiled import BlockIndex

    if hasattr(arrays, "model_arrays"):
        arrays = arrays.model_arrays()
    elif hasattr(arrays, "arrays") and not isinstance(arrays, dict):
        arrays = arrays.arrays
    idx = BlockIndex.build(list(arrays["param_names"]))
    widths = [int(w) for w in arrays["widths"]]
    host_toas = [len(v) for v in (arrays.get("host") or {}).get("y", [])]
    return DatasetShape(
        pulsars=int(arrays["P_real"]),
        toas=max(host_toas) if host_toas else int(arrays["Nmax"]),
        basis=max(widths),
        modes=int(len(idx.rho)))


class BucketTable:
    """An ordered set of :class:`BucketSpec` shapes with smallest-cover
    routing."""

    def __init__(self, buckets):
        buckets = list(buckets)
        if not buckets:
            raise ValueError("BucketTable needs at least one bucket")
        self.buckets = sorted(buckets, key=BucketSpec.cost)

    @classmethod
    def ladder(cls, modes, pulsars=(8, 46), toas=(128, 1024),
               basis=None) -> "BucketTable":
        """A simple doubling ladder: the cross product of the given
        pulsar and TOA pads (basis defaults to a generous
        ``tm + 2*modes*2`` per TOA tier)."""
        if basis is None:
            basis = tuple(20 + 4 * int(modes) for _ in toas)
        out = []
        for p in pulsars:
            for t, b in zip(toas, basis):
                out.append(BucketSpec(int(p), int(t), int(b), int(modes)))
        return cls(out)

    def route(self, shape: DatasetShape) -> BucketSpec:
        """Smallest covering bucket, or raise :class:`BucketOverflow`
        (typed, with the nearest bucket attached)."""
        for b in self.buckets:          # sorted by cost: first hit wins
            if b.covers(shape):
                return b
        same_k = [b for b in self.buckets if b.modes == shape.modes]
        nearest = max(same_k or self.buckets, key=BucketSpec.cost)
        raise BucketOverflow(shape, nearest)

    def route_pta(self, arrays) -> BucketSpec:
        return self.route(probe_shape(arrays))
