"""Publish-aware sharded serving: per-shard epochs over the unified core.

``ShardedIndexService`` owns N key-partitioned ``FITingTree`` writers -- the
paper's structure recursed once, with the replicated shard-boundary router
(:func:`repro_torch.index.table.shard_boundaries`) as the top level.  Each
shard has its *own* write->publish->serve pipeline from ``repro_torch.index.snapshot``:

    shard d:  FITingTree  --publish-->  Snapshot(epoch_d)  --install-->  handle_d

so epochs advance independently.  ``insert`` routes to the owning shard;
``publish`` re-segments and republishes **only dirty shards** (shards with
buffered inserts since their last publish), and each shard's ``ServingHandle``
swaps atomically -- a slow or write-hot shard never blocks reads on the
others, and a clean shard's epoch number is untouched by its neighbours'
publishes.

Reads return *global* ranks: shard runs are contiguous in key order, so a
query's global rank is its local rank plus the summed key counts of the
preceding shards' current snapshots.  Cross-shard reads are per-shard
consistent (each lookup pins one shard snapshot); a batch spanning shards may
observe different shards at different epochs -- exactly the contract the
per-shard publish cadence buys.

**Adaptive rebalancing.**  Boundaries are not frozen at construction: a
write-hot key range makes one shard grow without bound, its publishes get
slower, and its lookup windows dominate tail latency.  ``rebalance()``
detects skew from the write-side loads (keys per shard plus
``pending_weight``-scaled unpublished inserts, against ``skew_threshold``),
recuts duplicate-safe equal-count boundaries over the merged current key
view, migrates key runs (and payloads) between the ``FITingTree`` writers via
their ``extract_range``/``splice_run`` path, republishes every shard into
*fresh* serving handles, and swaps the whole routing view -- boundaries and
handles together -- as one immutable versioned :class:`ShardSet` with a
single reference assignment (the same discipline as
``ServingHandle.install``).  An in-flight lookup that pinned the old
``ShardSet`` keeps a fully consistent boundaries+snapshots view; it can never
mix old routing with new offsets.  Pass ``auto_rebalance=True`` to trigger
the check after every ``publish()``.

``metrics()`` exposes the service-level view (ShardSet version, rebalance
counters, current imbalance, query counters) and one row per shard (epoch,
segment count, key count, pending inserts, the routing cut *and* the
installed snapshot's actual first key) for cadence tuning and dashboards.

Every read verb pins one :class:`PinnedView` and answers with one engine
call.  Past one shard the view's engine runs over a :class:`ViewTable`: the
pinned snapshots' tables end to end, one error-bounded table over the whole
column, so the engine's own segment route takes the place of a shard route
and its ranks are global.  A view of one shard answers from shard 0's own
engine: ``IndexService`` is this service at one shard.

``pack_shard_tables`` is the shared builder bridge: it pads a list of
per-shard ``SegmentTable``s into rectangular (D, S_max) metadata arrays, the
form a device-sharded plane consumes.

Port of ``repro.index.sharded`` (host code, copied; the view table is the
port's own).  Raw-knob services default to the ``cuda`` backend, so a read
serves on the CUDA card (one launch of the fused search kernel over the
view, with one copy in and one out) unless the caller names another backend
or passes ``engine_opts={"cuda": {"device": "cpu"}}``.  Publishing
re-converts only the dirty shards: a clean shard keeps its snapshot, so its
table keeps its cached device form
(``repro_torch.index.engine.device_index``), from which the next view's form
is assembled on the device.  A publish re-fits
where the shard's tables serve: on the card (one launch of the batched
ShrinkingCone kernel a shard) for a backend on a CUDA device, on the host for
``numpy`` or a CPU device.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import time
import warnings
from typing import TYPE_CHECKING, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.analysis import sanitizer
from repro_torch.analysis.contracts import hot_path
from repro_torch.index.table import (SegmentTable, route_keys,
                                     shard_boundaries, shard_partition)
from repro_torch.kernels.shrinking_cone import load_library

from .device import DeviceIndex
from .engine import (LookupEngine, device_index, inject_monitor,
                     serving_device)
from .query import PointResult, RangeResult, check_range, check_side
from .snapshot import ServingHandle, Snapshot, SnapshotPublisher
from .telemetry import (CH_PUBLISH, CH_REBALANCE, CH_SERVED_KEYS, Monitor,
                        ServiceMetrics, ShardMetrics, span, tier_metrics)

if TYPE_CHECKING:  # runtime import is lazy (fit builds services via plans)
    from .fit import IndexPlan

# every Nth lookup/search call contributes a key sample to the served-keys
# reservoir (CH_SERVED_KEYS); keeps the hot-path telemetry cost amortized
_KEY_SAMPLE_EVERY = 8
_KEY_SAMPLE_WIDTH = 64


def _refit_device(backend: str, engine_opts: dict,
                  buffer_size: int) -> torch.device:
    """Where a shard's publish re-fits: where its tables serve.  A service
    that takes inserts loads the fit kernel's library there now, so that no
    publish pays for it; a read-only one never re-fits."""
    device = serving_device(backend, engine_opts)
    if buffer_size > 0:
        load_library(device)
    return device


class PackedShardTables(NamedTuple):
    """Rectangular (D, S_max) numpy form of D per-shard segment tables.

    Rows are padded so every shard routes correctly in isolation: start keys
    pad with +inf (never routed to -- searchsorted lands on the last real
    segment), slopes with 0, and base/seg_end with the shard's own key count
    (an empty trailing window).
    """
    seg_start: np.ndarray   # (D, S_max) f64, +inf padded
    slope: np.ndarray       # (D, S_max) f64, 0 padded
    base: np.ndarray        # (D, S_max) i64, n_keys padded
    seg_end: np.ndarray     # (D, S_max) i64, n_keys padded
    boundaries: np.ndarray  # (D,) f64 first key per shard (the router)
    s_max: int


def pack_shard_tables(tables: Sequence[SegmentTable]) -> PackedShardTables:
    """Pad per-shard segment metadata into the rectangular device layout.

    An *empty* shard inherits the next non-empty shard's first key as its
    boundary (it owns an empty key range just below its successor), keeping
    ``boundaries`` non-decreasing -- the ``route_keys`` precondition.  A bare
    +inf for a non-tail empty shard would break the sort and misroute every
    query at or above it.  Trailing empty shards keep +inf: no finite query
    ever routes to them.  A query equal to an inherited boundary routes to
    the *last* shard with that boundary (searchsorted side="right"), i.e. the
    non-empty owner."""
    d = len(tables)
    s_max = max(t.n_segments for t in tables)
    seg_start = np.full((d, s_max), np.inf, np.float64)
    slope = np.zeros((d, s_max), np.float64)
    base = np.empty((d, s_max), np.int64)
    seg_end = np.empty((d, s_max), np.int64)
    boundaries = np.empty((d,), np.float64)
    for i, t in enumerate(tables):
        s = t.n_segments
        seg_start[i, :s] = t.start_key
        slope[i, :s] = t.slope
        base[i, :s] = t.base
        base[i, s:] = t.n_keys
        seg_end[i, :s] = t.seg_end
        seg_end[i, s:] = t.n_keys
        boundaries[i] = t.keys[0] if t.n_keys else np.inf
    for i in range(d - 2, -1, -1):      # backfill empty interior boundaries
        if tables[i].n_keys == 0:
            boundaries[i] = boundaries[i + 1]
    # the packed form is a published view shared across device bridges:
    # freeze it like any snapshot so in-place edits raise at the write site
    return PackedShardTables(
        sanitizer.published_array(seg_start), sanitizer.published_array(slope),
        sanitizer.published_array(base), sanitizer.published_array(seg_end),
        sanitizer.published_array(boundaries), s_max)


@dataclasses.dataclass(frozen=True)
class ShardSet:
    """One immutable, versioned routing view: boundaries + serving handles.

    Published as a whole with a single reference assignment
    (``service._shard_set = ShardSet(...)``), mirroring
    ``ServingHandle.install``: a reader that pinned a ``ShardSet`` resolves
    routing, snapshots, and rank offsets against that one object, so a
    concurrent rebalance can never make it mix old boundaries with new
    handles (or vice versa).  Regular publishes reuse the current set's
    handles (boundaries are unchanged); a rebalance always builds fresh
    handles so retired sets keep serving their own epoch consistently."""
    version: int
    boundaries: np.ndarray               # (D,) f64 router cuts
    handles: tuple[ServingHandle, ...]   # one per shard, same order

    def __post_init__(self):
        # published = immutable: a reader that pinned this set must never see
        # its routing column change underneath it (freeze copies scratch views)
        object.__setattr__(self, "boundaries",
                           sanitizer.published_array(self.boundaries))


class ViewTable:
    """The pinned snapshots' tables end to end: one table over the column.

    Duplicate-safe cuts, and inserts that land by routing, put every key of
    shard d-1 below every key of shard d.  So the non-empty tables end to
    end -- ``base`` and ``seg_end`` raised by the keys of the preceding
    snapshots -- are one valid error-bounded table: each segment still
    predicts its keys within its shard's error, the start keys still
    ascend, and a window crossing a shard edge crosses into keys all below
    the query on the left or all above it on the right.  So an engine's
    ranks over it are the global ranks.  ``error`` is the largest shard
    error (a wider window stays exact).

    Its device form is assembled on the device from the shards' cached
    forms (:meth:`assemble`, called by ``engine.device_index``), so a clean
    shard is never uploaded again.  The host arrays (:attr:`host`) are built
    only when a host path first asks, e.g. the ``numpy`` tier or
    ``point``'s f64 compare."""

    def __init__(self, tables: Sequence[SegmentTable], offsets: Sequence[int],
                 monitor: Monitor | None = None):
        self.tables = tuple(tables)
        self.offsets = tuple(int(o) for o in offsets)
        self.n_keys = self.offsets[-1] + self.tables[-1].n_keys
        self.n_segments = sum(t.n_segments for t in self.tables)
        self.error = max(int(t.error) for t in self.tables)
        self.monitor = monitor
        self._device_cache: dict = {}

    @classmethod
    def of(cls, snaps: Sequence[Snapshot], offsets: np.ndarray,
           monitor: Monitor | None = None) -> "ViewTable | SegmentTable":
        """The view of ``snaps`` at their rank ``offsets``: an empty shard
        adds nothing, and with no keys at all it is an empty table."""
        parts = [(s.table, o) for s, o in zip(snaps, offsets.tolist())
                 if s.n_keys]
        if not parts:
            return SegmentTable.empty(max(s.table.error for s in snaps))
        tables, offs = zip(*parts)
        return cls(tables, offs, monitor)

    def assemble(self, device: torch.device) -> DeviceIndex:
        """The device form: each shard's cached form (uploaded where it has
        none yet), concatenated on ``device``, ``base`` and ``seg_end``
        raised by the shard's offset there.  Positions must fit the form's
        int32."""
        if self.n_keys > 2 ** 31 - 1:
            raise ValueError(f"a view of {self.n_keys} keys does not fit the "
                             "device form's int32 positions")
        with span(self.monitor, "service.view_build", len(self.tables),
                  self.n_segments):
            forms = [device_index(t, device) for t in self.tables]

            def cat(field, lift=False):
                return torch.cat([getattr(f, field) + o if lift
                                  else getattr(f, field)
                                  for f, o in zip(forms, self.offsets)])
            return DeviceIndex(seg_start=cat("seg_start"), slope=cat("slope"),
                               base=cat("base", True),
                               seg_end=cat("seg_end", True), keys=cat("keys"),
                               error=self.error)

    @functools.cached_property
    def host(self) -> SegmentTable:
        """The host arrays, built on first use."""
        def cat(field, lift=False):
            return np.concatenate([getattr(t, field) + o if lift
                                   else getattr(t, field)
                                   for t, o in zip(self.tables, self.offsets)])
        return SegmentTable(start_key=cat("start_key"), slope=cat("slope"),
                            base=cat("base", True),
                            seg_end=cat("seg_end", True), keys=cat("keys"),
                            error=self.error)

    def __getattr__(self, name: str):
        # every other table attribute (keys, window, ...) is the host's
        if name.startswith("_") or name == "host":
            raise AttributeError(name)
        return getattr(self.host, name)


@dataclasses.dataclass(frozen=True)
class PinnedView:
    """One read verb's pinned view: a ShardSet and, from one pin of each of
    its handles, every shard's snapshot, the rank offsets and total key
    count of those snapshots, and the one engine that answers the view:
    shard 0's own at one shard, else one over their :class:`ViewTable`."""
    shard_set: ShardSet
    snaps: tuple[Snapshot, ...]
    engine: LookupEngine         # the one engine answering the view
    offsets: np.ndarray          # (D,) i64 keys in the preceding snapshots
    n_keys: int                  # keys in all the pinned snapshots


@dataclasses.dataclass(frozen=True)
class ShardStats:
    """One shard's observable serving state (a point-in-time sample).

    ``boundary`` is the *router* cut -- the first key routed to this shard
    under the current ``ShardSet`` (shard 0 also takes everything below it);
    this is the value that routes.  ``snapshot_first_key`` is the installed
    snapshot's actual first key, which drifts below/above the cut between
    publishes (inserts land by routing, so shard 0's snapshot can start
    below its cut) -- report both, dashboard the drift, trust ``boundary``
    for routing.  ``snapshot_first_key`` is NaN for an empty snapshot."""
    shard: int                # shard id (position in key order)
    boundary: float           # router cut (this one routes)
    epoch: int                # epoch of the shard's installed snapshot
    n_segments: int           # segments in the installed snapshot
    n_keys: int               # keys served by the installed snapshot
    pending_inserts: int      # inserts buffered since this shard's last publish
    snapshot_first_key: float = float("nan")  # installed snapshot's first key
    version: int = 1          # ShardSet version the sample was taken from


class ShardedIndexService:
    """N key-partitioned writable indexes, each with its own epoch stream.

    Construction partitions the (sorted) build keys into equal-count
    contiguous shards (:func:`shard_partition`; cuts snap to unique-key run
    starts and the tail stays in the last shard -- nothing is dropped) and
    publishes epoch 1 on every shard.  From then on writes and publishes are
    per-shard:

        svc = ShardedIndexService(keys, error=64, n_shards=8, buffer_size=16)
        svc.insert(k)          # routed to the owning shard, buffered (Alg. 4)
        svc.publish()          # republishes ONLY dirty shards; clean shards
                               # keep their snapshot and epoch number
        svc.lookup(q)          # global ranks, any engine backend
        svc.rebalance()        # recut boundaries if shard growth skewed

    ``backend`` may be any registered engine, including ``"dispatch"`` (the
    batch-size-aware tier router in ``repro_torch.index.engine``); the
    default is ``"cuda"``, on the CUDA card.

    Construction is plan-first (see ``repro_torch.index.fit``): pass
    ``plan=`` (an ``IndexPlan``, e.g. from ``fit.plan(keys, FitSpec(...))``) and the
    service takes its error / shard count / buffer / backend / publish
    cadence / dispatch thresholds from it; or pass the raw expert knobs,
    which are wrapped in a trivially-resolved plan so ``svc.plan`` always
    answers "what configuration is this service running?".
    :meth:`from_plan` is the classmethod form used by ``fit.open_index``.

    Rebalancing knobs: ``skew_threshold`` is the max/mean keys-per-shard
    ratio above which :meth:`rebalance` acts (:meth:`needs_rebalance`);
    ``pending_weight`` scales unpublished per-shard insert counts into the
    load metric (pressure forecast: a shard with heavy in-flight traffic is
    treated as still growing); ``auto_rebalance=True`` runs the check after
    every :meth:`publish`.
    """

    def __init__(self, keys: np.ndarray, error: int | None = None, *,
                 plan: "IndexPlan | None" = None, n_shards: int | None = None,
                 buffer_size: int | None = None,
                 payload: np.ndarray | None = None,
                 mode: str = "paper", backend: str | None = None,
                 engine_opts: dict[str, dict] | None = None,
                 publish_every: int | None = None,
                 skew_threshold: float = 2.0,
                 pending_weight: float = 1.0,
                 auto_rebalance: bool = False,
                 assume_sorted: bool = False,
                 monitor: Monitor | None = None):
        # lazy: repro_torch.core.tree imports repro_torch.index.table at
        # module level
        from repro_torch.core.tree import FITingTree
        from .fit import IndexPlan

        raw = {"error": error, "n_shards": n_shards,
               "buffer_size": buffer_size, "backend": backend,
               "publish_every": publish_every}
        if plan is None:
            if error is None:
                raise TypeError("pass error=... (expert knobs) or plan=... "
                                "(an IndexPlan from repro_torch.index.fit)")
            plan = IndexPlan.from_knobs(
                error=error,
                n_shards=4 if n_shards is None else n_shards,
                buffer_size=0 if buffer_size is None else buffer_size,
                backend="cuda" if backend is None else backend,
                publish_every=publish_every)
        else:
            clashing = sorted(k for k, v in raw.items() if v is not None)
            if clashing:
                raise TypeError("pass either the raw knobs or plan=, not "
                                f"both -- the plan already fixes "
                                f"{', '.join(clashing)}")
        self.plan = plan
        error, n_shards = plan.error, plan.n_shards
        buffer_size, backend = plan.buffer_size, plan.backend
        publish_every = plan.publish_every
        self.monitor = monitor
        engine_opts = inject_monitor(plan.merge_engine_opts(engine_opts),
                                     monitor)

        if publish_every is not None and buffer_size == 0:
            raise ValueError("publish_every requires buffer_size > 0 "
                             "(a read-only service never republishes)")
        if skew_threshold < 1.0:
            raise ValueError("skew_threshold must be >= 1.0 "
                             "(max/mean load ratio; 1.0 is perfectly even)")
        keys = np.asarray(keys, np.float64)
        if not assume_sorted:
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            if payload is not None:
                payload = np.asarray(payload)[order]

        self.error = int(error)
        self.buffer_size = int(buffer_size)
        self.default_backend = backend
        self.publish_every = publish_every
        self.has_payload = payload is not None
        self._mode = mode
        # serializes the mutators (insert/publish/rebalance/apply_plan);
        # re-entrant because insert -> publish -> rebalance nests, and a
        # Replanner swap may land while a cadence publish holds the lock.
        # Readers never take it: they pin the immutable ShardSet instead.
        self._write_lock = sanitizer.make_rlock(
            "ShardedIndexService._write_lock")
        self._sample_ctr = itertools.count()
        self.skew_threshold = float(skew_threshold)
        self.pending_weight = float(pending_weight)
        self.auto_rebalance = bool(auto_rebalance)
        self._engine_opts = engine_opts
        self._rebalances = 0
        self._rebalance_skipped = 0
        self._last_rebalance: dict | None = None
        # per-shape query counters (queries for point-shaped verbs, scans for
        # range, bound-pairs for count) -- see metrics().  Guarded by a lock:
        # dict `+=` is a read-modify-write, and concurrent callers drive these
        # verbs from many threads -- unlocked increments lose updates.
        self._counts_lock = sanitizer.make_lock(
            "ShardedIndexService._counts_lock")
        self._query_counts = {"points": 0, "ranges": 0, "counts": 0,
                              "predecessors": 0, "successors": 0,
                              "searches": 0}

        bounds, splits = shard_partition(keys, n_shards)
        offsets = np.concatenate(
            [[0], np.cumsum([s.shape[0] for s in splits])[:-1]]).astype(np.int64)
        self.writers = [
            FITingTree(split, error=error, buffer_size=buffer_size, mode=mode,
                       payload=(None if payload is None else
                                payload[offsets[d]:offsets[d] + split.shape[0]]),
                       assume_sorted=True)
            for d, split in enumerate(splits)]
        self._fit_device = _refit_device(backend, engine_opts, buffer_size)
        self.publishers = [SnapshotPublisher(t, monitor, self._fit_device)
                           for t in self.writers]
        handles = tuple(ServingHandle(engine_opts, monitor)
                        for _ in self.writers)
        self._pending = [0] * n_shards
        for pub, handle in zip(self.publishers, handles):
            handle.install(pub.publish())     # epoch 1 everywhere
        self._shard_set = ShardSet(version=1, boundaries=bounds,
                                   handles=handles)
        # the last pinned view past one shard: (ShardSet, snapshots, handle)
        self._view: tuple | None = None

    @classmethod
    def from_plan(cls, keys: np.ndarray, plan: "IndexPlan", *,
                  payload: np.ndarray | None = None,
                  **service_kwargs) -> "ShardedIndexService":
        """Build from a resolved :class:`repro_torch.index.fit.IndexPlan` (the
        ``fit.open_index`` path).  ``service_kwargs`` are the serving-policy
        knobs the plan does not fix (``skew_threshold``, ``pending_weight``,
        ``auto_rebalance``, ``mode``, ``engine_opts``, ``assume_sorted``)."""
        return cls(keys, plan=plan, payload=payload, **service_kwargs)

    # ------------------------------------------------------------------ shape
    def _pin_shard_set(self) -> ShardSet:
        """THE read-path pin: one reference read of the live routing view.
        Every query verb goes through here exactly once per operation (RI002)
        and reports the pinned version to the sanitizer's PinTracker, which
        asserts no verb mixes two ShardSet versions end-to-end."""
        ss = self._shard_set
        sanitizer.observe_pin(ss.version)
        return ss

    @property
    def n_shards(self) -> int:
        return len(self.writers)

    @property
    def shard_set(self) -> ShardSet:
        """The current immutable routing view (pin it for consistency)."""
        return self._shard_set

    @property
    def boundaries(self) -> np.ndarray:
        """Router cuts of the current ShardSet (first key per shard)."""
        return self._shard_set.boundaries

    @property
    def handles(self) -> tuple[ServingHandle, ...]:
        """Serving handles of the current ShardSet (one per shard)."""
        return self._shard_set.handles

    @property
    def pending_inserts(self) -> int:
        """Total inserts buffered across shards since their last publishes."""
        return sum(self._pending)

    def shard_of(self, key: float) -> int:
        """The shard owning ``key`` (route through the boundary router)."""
        return int(route_keys(self._shard_set.boundaries, np.float64(key)))

    def epochs(self) -> list[int]:
        """Current epoch per shard (independent streams)."""
        return [h.epoch for h in self._shard_set.handles]

    def metrics(self) -> ServiceMetrics:
        """The typed observability snapshot (:class:`repro_torch.index.
        telemetry.ServiceMetrics`): ShardSet version, served plan revision, rebalance
        counters, current write-side imbalance, per-shape query counters
        (``points`` covers ``lookup``/``point``, ``ranges`` counts scans,
        ``counts`` counts bound pairs, ``searches`` the raw primitive -- for
        checking a deployed ``FitSpec.range_fraction`` against reality), one
        :class:`ShardMetrics` row per shard (epoch, size, pending writes,
        routing cut, snapshot first key, write-side load) and -- when a
        monitor is attached -- the measured per-tier cost profile."""
        ss = self._shard_set
        loads = self.shard_loads()
        with self._counts_lock:
            counts = dict(self._query_counts)
        shards = []
        for d, (handle, pend) in enumerate(zip(ss.handles, self._pending)):
            snap = handle.current()
            first = float(snap.table.keys[0]) if snap.n_keys else float("nan")
            shards.append(ShardMetrics(
                shard=d, boundary=float(ss.boundaries[d]), epoch=snap.epoch,
                n_segments=snap.table.n_segments, n_keys=snap.n_keys,
                pending_inserts=pend, snapshot_first_key=first,
                load=float(loads[d]) if d < loads.size else 0.0))
        return ServiceMetrics(
            service="sharded", shard_set_version=ss.version,
            plan_revision=self.plan.revision, n_shards=self.n_shards,
            imbalance=self.imbalance(), rebalances=self._rebalances,
            rebalance_skipped=self._rebalance_skipped,
            last_rebalance=self._last_rebalance,
            pending_inserts=self.pending_inserts, query_counts=counts,
            shards=tuple(shards), tiers=tier_metrics(self.monitor))

    def stats(self) -> list[ShardStats]:
        """Deprecated: use :meth:`metrics`\\ ``().shards``.  Per-shard
        observability sample in the legacy ``ShardStats`` shape."""
        warnings.warn(f"{type(self).__name__}.stats() is deprecated; use "
                      "metrics().shards", DeprecationWarning, stacklevel=2)
        m = self.metrics()
        return [ShardStats(shard=s.shard, boundary=s.boundary, epoch=s.epoch,
                           n_segments=s.n_segments, n_keys=s.n_keys,
                           pending_inserts=s.pending_inserts,
                           snapshot_first_key=s.snapshot_first_key,
                           version=m.shard_set_version)
                for s in m.shards]

    def service_stats(self) -> dict:
        """Deprecated: use :meth:`metrics`.  The legacy service-level dict,
        derived field-for-field from the typed snapshot."""
        warnings.warn(f"{type(self).__name__}.service_stats() is "
                      "deprecated; use metrics()", DeprecationWarning,
                      stacklevel=2)
        m = self.metrics()
        return {"version": m.shard_set_version,
                "n_shards": m.n_shards,
                "imbalance": m.imbalance,
                "rebalances": m.rebalances,
                "rebalance_skipped": m.rebalance_skipped,
                "last_rebalance": m.last_rebalance,
                "pending_inserts": m.pending_inserts,
                "query_counts": m.query_counts}

    def _count(self, shape: str, n: int) -> None:
        """Atomic query-counter bump (verbs run concurrently under the async
        front door; an unlocked ``dict +=`` would lose updates)."""
        with self._counts_lock:
            self._query_counts[shape] += n

    def prewarm(self, backend: str | None = None,
                batch_sizes: Sequence[int] | None = None) -> None:
        """Build the engine reads use for ``backend`` (placing the tables on
        its device: past one shard, assembling the view's form) and run it
        once at ``batch_sizes`` before serving traffic, so the first batch
        skips the lazy conversion and the kernel's first-use build.  An
        engine without a ``prewarm`` (a custom registered backend) is just
        built."""
        eng = self._pin_view(backend).engine
        warm = getattr(eng, "prewarm", None)
        if warm is not None:
            warm(batch_sizes=batch_sizes)

    # ------------------------------------------------------------- write path
    def insert(self, key: float, value=None) -> None:
        """Buffer an insert in the owning shard (Alg. 4).  Invisible to
        lookups until that shard publishes.  A batch of one:
        :meth:`insert_many`."""
        self.insert_many([key], None if value is None else [value])

    def insert_many(self, keys, values=None) -> None:
        """Buffer a batch of inserts in arrival order, each in its owning
        shard (Alg. 4).  ``_write_lock`` is taken once and one
        ``route_keys`` call routes the batch; each shard takes its keys in
        arrival order (``FITingTree.insert_many``).  An auto-publish lands
        after exactly the key that brings the pending count to
        ``publish_every``, and the keys after it stay pending.  Only a
        rebalance inside that publish (``auto_rebalance``) has the rest
        routed again, by the new cuts."""
        if self.buffer_size == 0:
            raise ValueError("service built read-only; pass buffer_size > 0 "
                             "to enable inserts")
        if values is not None and not self.has_payload:
            raise ValueError("service built without payloads (clustered "
                             "index); pass payload= at construction to store "
                             "values")
        keys = np.asarray(keys, np.float64).ravel()
        n = keys.shape[0]
        if values is not None and len(values) != n:
            raise ValueError(f"{len(values)} values for {n} keys")
        vals = None if values is None else list(values)
        mon = self.monitor
        with self._write_lock:
            a, routed_by = 0, None
            while a < n:
                b = n
                if self.publish_every is not None:
                    b = min(n, a + max(self.publish_every
                                       - self.pending_inserts, 1))
                with span(mon, "sharded.insert") as sp:
                    ss = self._shard_set
                    if ss is not routed_by:          # first, or recut
                        routed_by, first = ss, a
                        owner = route_keys(ss.boundaries, keys[a:])
                    part = owner[a - first:b - first]
                    order = np.argsort(part, kind="stable")
                    shards, starts = np.unique(part[order], return_index=True)
                    ends = np.r_[starts[1:], b - a]
                    for d, s, e in zip(shards.tolist(), starts.tolist(),
                                       ends.tolist()):
                        idx = order[s:e] + a
                        self.writers[d].insert_many(
                            keys[idx], None if vals is None else
                            [vals[i] for i in idx.tolist()])
                        self._pending[d] += e - s
                    sp.tag(b - a, len(shards))
                a = b
                if self.publish_every is not None and \
                        self.pending_inserts >= self.publish_every:
                    self.publish()

    def _shard_dirty(self, sid: int) -> bool:
        """Unpublished writes on shard ``sid``: service-routed inserts,
        direct writer inserts still in Alg. 4 buffers, or direct inserts
        already merged into pages (visible as a key-count drift between the
        writer and the installed snapshot)."""
        return (self._pending[sid] > 0
                or bool(self.writers[sid].dirty_segments())
                or self.writers[sid].n_keys
                != self._shard_set.handles[sid].current().n_keys)

    def publish(self, shards: Sequence[int] | None = None,
                force: bool = False) -> dict[int, Snapshot]:
        """Cut a new epoch on every dirty shard; leave clean shards untouched.

        A shard is dirty when it has unpublished writes -- whether routed
        through :meth:`insert` or applied directly to its ``FITingTree``
        writer.  Pass ``shards`` to restrict the sweep, ``force=True`` to
        republish clean shards too (cadence-loop safe either way: with
        nothing dirty this is a no-op returning ``{}``).  Returns the newly
        installed snapshots keyed by shard id.

        With ``auto_rebalance=True`` a skew check runs after the sweep and
        may recut boundaries (see :meth:`rebalance`); a recut that is
        impossible (fewer distinct keys than shards) is skipped and counted
        in ``metrics().rebalance_skipped``.
        """
        with self._write_lock:
            t0 = time.perf_counter_ns()
            ss = self._shard_set
            targets = range(self.n_shards) if shards is None else shards
            published: dict[int, Snapshot] = {}
            for sid in targets:
                if not force and not self._shard_dirty(sid):
                    continue
                with span(self.monitor, "sharded.publish") as sp:
                    before = self.writers[sid].n_segments
                    snap = self.publishers[sid].publish()
                    ss.handles[sid].install(snap)
                    sp.tag(sid, snap.n_refit, before, snap.table.n_segments)
                self._pending[sid] = 0
                published[sid] = snap
            if self.auto_rebalance and published and self.needs_rebalance():
                try:
                    self.rebalance()
                except ValueError:   # < n_shards distinct keys: no safe recut
                    self._rebalance_skipped += 1
            if published and self.monitor is not None:
                self.monitor.record(CH_PUBLISH, len(published),
                                    time.perf_counter_ns() - t0)
            return published

    # ------------------------------------------------------------- rebalance
    def shard_loads(self) -> np.ndarray:
        """Write-side load per shard: the writer's current key count (pages +
        Alg. 4 buffers) plus ``pending_weight`` x its unpublished service
        inserts -- the pending term forecasts continued pressure on a
        write-hot shard before its next publish."""
        loads = np.array([w.n_keys for w in self.writers], np.float64)
        return loads + self.pending_weight * np.asarray(self._pending,
                                                        np.float64)

    def imbalance(self) -> float:
        """Max/mean of :meth:`shard_loads` (1.0 = perfectly even)."""
        loads = self.shard_loads()
        mean = float(loads.mean())
        return float(loads.max() / mean) if mean > 0 else 1.0

    def needs_rebalance(self) -> bool:
        """True when the load imbalance exceeds ``skew_threshold``."""
        return self.n_shards > 1 and self.imbalance() > self.skew_threshold

    def rebalance(self, force: bool = False) -> dict | None:
        """Recut shard boundaries to equal counts and migrate the key runs.

        No-op (returns ``None``) when balanced, unless ``force=True``.
        Otherwise: flush every writer, recut duplicate-safe equal-count
        boundaries over the merged current key view (raises ``ValueError``
        when the view has fewer distinct keys than shards), move the key
        runs that changed owner between writers via
        ``extract_range``/``splice_run`` (payloads travel with their keys),
        republish every shard into *fresh* serving handles, and publish the
        new routing view atomically as the next :class:`ShardSet` version.
        Readers never block: an in-flight lookup keeps the old set, whose
        retired snapshots still serve their own epochs correctly.

        Returns a summary dict (also kept as ``metrics().last_rebalance``):
        version, keys moved, and the imbalance before/after.
        """
        with self._write_lock:
            return self._rebalance_locked(force)

    def _rebalance_locked(self, force: bool) -> dict | None:
        if self.n_shards == 1:
            return None
        before = self.imbalance()
        if not force and before <= self.skew_threshold:
            return None
        t0 = time.perf_counter_ns()
        ss = self._shard_set    # one pinned read, reused through the swap
        for w in self.writers:
            w.flush(self._fit_device)
        merged = np.concatenate([w.as_table().keys for w in self.writers])
        new_bounds = shard_boundaries(merged, self.n_shards)
        if not force and np.array_equal(new_bounds, ss.boundaries):
            # the recut cannot help (duplicate-snapped cuts already match the
            # current ones): nothing would move, so skip the churn of
            # republishing every shard; counted for observability
            self._rebalance_skipped += 1
            return None

        n = self.n_shards
        moves_k: list[list[np.ndarray]] = [[] for _ in range(n)]
        moves_p: list[list[np.ndarray]] = [[] for _ in range(n)]
        moved = 0
        for d, w in enumerate(self.writers):
            parts = []
            if d > 0:                # keys now owned by an earlier shard
                parts.append(w.extract_range(-np.inf, new_bounds[d]))
            if d + 1 < n:            # keys now owned by a later shard
                parts.append(w.extract_range(new_bounds[d + 1], np.inf))
            for part_k, part_p in parts:
                if part_k.shape[0] == 0:
                    continue
                tgt = route_keys(new_bounds, part_k)
                for t in np.unique(tgt):
                    sel = tgt == t
                    moves_k[t].append(part_k[sel])
                    if part_p is not None:
                        moves_p[t].append(part_p[sel])
                    moved += int(sel.sum())
        for t in range(n):
            if not moves_k[t]:
                continue
            run = np.concatenate(moves_k[t])
            pl = np.concatenate(moves_p[t]) if moves_p[t] else None
            order = np.argsort(run, kind="stable")
            self.writers[t].splice_run(run[order],
                                       None if pl is None else pl[order])

        new_handles = tuple(ServingHandle(self._engine_opts, self.monitor)
                            for _ in self.writers)
        for pub, handle in zip(self.publishers, new_handles):
            handle.install(pub.publish())
        new_set = ShardSet(version=ss.version + 1, boundaries=new_bounds,
                           handles=new_handles)
        # the swap: one reference assignment publishes boundaries + handles
        self._shard_set = new_set
        self._pending = [0] * n
        self._rebalances += 1
        self._last_rebalance = {
            "version": new_set.version, "moved_keys": moved,
            "imbalance_before": before, "imbalance_after": self.imbalance()}
        if self.monitor is not None:
            self.monitor.record(CH_REBALANCE, moved,
                                time.perf_counter_ns() - t0)
        return self._last_rebalance

    # ------------------------------------------------------------- replanning
    def apply_plan(self, new_plan: "IndexPlan", *,
                   reshard: bool = True) -> "IndexPlan":
        """Hot-swap the served configuration to ``new_plan`` (a
        ``plan.replace(...)`` revision -- the ``Replanner`` path, also usable
        directly).  Never tears a reader: every path ends in a single
        reference assignment of a fresh versioned :class:`ShardSet`, exactly
        the rebalance discipline, so an in-flight lookup keeps serving its
        pinned view.

        Threshold/backend-only changes are *lightweight*: fresh serving
        handles with the new engine opts (new dispatch cut-overs, new
        monitor-threaded tiers) are installed over the **current snapshots**
        -- no re-segmentation, no epoch reset.  A change to ``error`` /
        ``buffer_size`` / (with ``reshard=True``) ``n_shards`` is
        *structural*: writers are flushed, the merged key+payload view is
        re-partitioned and re-segmented under the new knobs, and every shard
        restarts its epoch stream at 1 (the shard count clamps to the
        distinct-key count, like construction).  Returns the plan actually
        served (``svc.plan``), which reflects any clamping."""
        with self._write_lock:
            # preserve caller-supplied engine opts, but let the new plan's
            # dispatch thresholds win over the old plan's stale ones
            base = {k: dict(v)
                    for k, v in (self._engine_opts or {}).items()}
            disp = base.get("dispatch")
            if disp is not None:
                for k in ("small_max", "large_min", "monitor"):
                    disp.pop(k, None)
            engine_opts = inject_monitor(new_plan.merge_engine_opts(base),
                                         self.monitor)
            structural = (int(new_plan.error) != self.error
                          or int(new_plan.buffer_size) != self.buffer_size
                          or (reshard
                              and int(new_plan.n_shards) != self.n_shards))
            if structural:
                new_plan = self._rebuild(new_plan, engine_opts, reshard)
            else:
                ss = self._shard_set
                handles = tuple(ServingHandle(engine_opts, self.monitor)
                                for _ in ss.handles)
                for old, new in zip(ss.handles, handles):
                    new.install(old.current())
                self._shard_set = ShardSet(version=ss.version + 1,
                                           boundaries=ss.boundaries,
                                           handles=handles)
                self._fit_device = _refit_device(new_plan.backend, engine_opts,
                                                 self.buffer_size)
                for pub in self.publishers:
                    pub.device = self._fit_device
                if new_plan.n_shards != self.n_shards:
                    new_plan = dataclasses.replace(new_plan,
                                                   n_shards=self.n_shards)
            self.plan = new_plan
            self.error = int(new_plan.error)
            self.buffer_size = int(new_plan.buffer_size)
            self.default_backend = new_plan.backend
            self.publish_every = (new_plan.publish_every
                                  if new_plan.buffer_size > 0 else None)
            self._engine_opts = engine_opts
            return self.plan

    def _rebuild(self, new_plan: "IndexPlan", engine_opts: dict,
                 reshard: bool) -> "IndexPlan":
        """Structural re-open under the write lock: merge every writer's
        current keys (+payloads), re-partition, re-segment with the new
        error/buffer, publish epoch 1 everywhere, swap one fresh ShardSet."""
        from repro_torch.core.tree import FITingTree
        for w in self.writers:
            w.flush(self._fit_device)
        keys = np.concatenate([w.as_table().keys for w in self.writers])
        payload = (np.concatenate([w.payload_column()
                                   for w in self.writers])
                   if self.has_payload else None)
        n_shards = int(new_plan.n_shards) if reshard else self.n_shards
        if keys.size == 0:
            n_shards = 1
        elif n_shards > 1:           # same clamp as shard_partition's safety
            distinct = 1 + int(np.count_nonzero(np.diff(keys) != 0))
            n_shards = max(1, min(n_shards, distinct))
        error = int(new_plan.error)
        buffer_size = int(new_plan.buffer_size)
        bounds, splits = shard_partition(keys, n_shards)
        offsets = np.concatenate(
            [[0], np.cumsum([s.shape[0] for s in splits])[:-1]]
        ).astype(np.int64)
        writers = [
            FITingTree(split, error=error, buffer_size=buffer_size,
                       mode=self._mode,
                       payload=(None if payload is None else
                                payload[offsets[d]:offsets[d]
                                        + split.shape[0]]),
                       assume_sorted=True)
            for d, split in enumerate(splits)]
        self._fit_device = _refit_device(new_plan.backend, engine_opts,
                                         buffer_size)
        publishers = [SnapshotPublisher(t, self.monitor, self._fit_device)
                      for t in writers]
        handles = tuple(ServingHandle(engine_opts, self.monitor)
                        for _ in writers)
        for pub, handle in zip(publishers, handles):
            handle.install(pub.publish())     # epoch 1 everywhere (restart)
        version = self._shard_set.version + 1
        self.writers = writers
        self.publishers = publishers
        self._pending = [0] * n_shards
        # the swap: readers pin either the old complete view or this one
        self._shard_set = ShardSet(version=version, boundaries=bounds,
                                   handles=handles)
        if n_shards != new_plan.n_shards:
            new_plan = dataclasses.replace(new_plan, n_shards=n_shards)
        return new_plan

    # -------------------------------------------------------------- read path
    def _pin_view(self, backend: str | None) -> PinnedView:
        """Pin ONE consistent read view: the current ShardSet, plus each
        shard's snapshot from one pin of its handle, and the engine over
        exactly those snapshots, so rank offsets, materialized keys/payloads
        and answers all come from a single epoch combination -- a
        concurrent publish or rebalance can never tear a batch or a scan
        that already pinned its view.  At one shard the engine is shard 0's
        own; past one, the engine over the snapshots' :class:`ViewTable`
        (:meth:`_view_for`).  Engines are cached per backend, so pinning
        is a few identity checks and a dict hit after the first call."""
        backend = backend or self.default_backend
        ss = self._pin_shard_set()
        states = [h._pin() for h in ss.handles]
        snaps = tuple(st[0] for st in states)
        sizes = np.asarray([s.n_keys for s in snaps], np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        if len(snaps) == 1:
            engine = ss.handles[0]._engine_from(states[0], backend)
        else:
            engine = self._view_for(ss, snaps, offsets).engine(backend)
        return PinnedView(ss, snaps, engine, offsets, int(sizes.sum()))

    def _view_for(self, ss: ShardSet, snaps: tuple[Snapshot, ...],
                  offsets: np.ndarray) -> ServingHandle:
        """The serving handle of the view of ``snaps`` (pinned from ``ss``):
        the last one built while it is still that combination, else a new
        one over their :class:`ViewTable`.  Its engines are built by the
        handle, lazily, under its lock, with ``ss``'s engine options; a
        reader holding an older view keeps that view's engine."""
        last = self._view
        if last is not None and last[0] is ss and all(
                a is b for a, b in zip(last[1], snaps)):
            return last[2]
        handle = ServingHandle(ss.handles[0]._engine_opts, self.monitor)
        handle.install(Snapshot(ViewTable.of(snaps, offsets, self.monitor),
                                epoch=0, n_refit=0))
        self._view = (ss, snaps, handle)
        return handle

    def _routed(self, view: PinnedView, queries, answer) -> np.ndarray:
        """The read path: global i64 ranks of ``queries`` against a pinned
        view, ``answer(engine, f64 queries)`` from the view's one engine.
        Its ranks are global already (shard 0's at one shard; past one, the
        view table's), and a miss is already ``-1``.  ``service.route``
        times the f64 conversion, tagged with the view's shard count and
        the engine calls the read makes: 1."""
        with span(self.monitor, "service.route", len(view.snaps), 1):
            q = np.asarray(queries, np.float64)
        return np.asarray(answer(view.engine, q), np.int64)

    def _search_view(self, view: PinnedView, queries,
                     side: str) -> np.ndarray:
        """Global insertion ranks against a pinned view: the ``search``
        primitive the other verbs here derive from."""
        return self._routed(view, queries, lambda e, q: e.search(q, side))

    def lookup(self, queries, backend: str | None = None) -> np.ndarray:
        """Global rank of each query across the current shard snapshots, -1
        if absent, all against one pinned view (:meth:`_pin_view`)."""
        self._count("points", int(np.size(queries)))
        self._sample_keys(queries)
        with sanitizer.pin_scope("lookup"):
            return self._routed(self._pin_view(backend), queries,
                                lambda e, q: e.lookup(q))

    def search(self, queries, side: str = "left",
               backend: str | None = None) -> np.ndarray:
        """Global ``searchsorted(all_keys, queries, side)`` insertion ranks
        across the current shard snapshots (the query plane's primitive)."""
        check_side(side)
        self._count("searches", int(np.size(queries)))
        self._sample_keys(queries)
        with sanitizer.pin_scope("search"):
            return self._search_view(self._pin_view(backend), queries, side)

    @hot_path
    def _sample_keys(self, queries) -> None:
        """Contribute every ``_KEY_SAMPLE_EVERY``-th call's leading queries
        to the served-keys reservoir -- the Replanner's re-plan key set.  One
        attribute read + None check when no monitor is attached."""
        mon = self.monitor
        if mon is not None and next(self._sample_ctr) % _KEY_SAMPLE_EVERY == 0:
            q = np.asarray(queries, np.float64).ravel()
            mon.record_many(CH_SERVED_KEYS, q[:_KEY_SAMPLE_WIDTH])

    def point(self, queries, backend: str | None = None) -> PointResult:
        """Typed membership: global leftmost rank + found flag per query
        (each shard's engine checks equality on the f64 queries)."""
        with sanitizer.pin_scope("point"):
            view = self._pin_view(backend)
            self._count("points", int(np.size(queries)))
            rank = self._routed(view, queries, lambda e, q: e.point(q).rank)
            return PointResult(rank=rank, found=rank >= 0)

    def count(self, lo, hi, backend: str | None = None) -> np.ndarray:
        """Keys in the inclusive ``[lo, hi]`` ranges (vectorized), resolved
        against one pinned view so both bounds see the same epochs."""
        with sanitizer.pin_scope("count"):
            view = self._pin_view(backend)
            lo = np.asarray(lo, np.float64)
            hi = np.asarray(hi, np.float64)
            counts = np.maximum(self._search_view(view, hi, "right")
                                - self._search_view(view, lo, "left"), 0)
            self._count("counts", int(counts.size))
            return counts.astype(np.int64)

    def range(self, lo, hi, *, materialize: bool = True,
              backend: str | None = None) -> RangeResult:
        """Inclusive ``[lo, hi]`` scan stitched across shards: the span may
        start mid-shard A and end mid-shard D; per-shard local spans lift to
        one global ``[lo_rank, hi_rank)`` via the pinned snapshot key counts,
        and materialized keys (and payloads, for a non-clustered index)
        concatenate in shard order -- all against the one pinned ShardSet,
        so a concurrent rebalance never tears the scan."""
        lo, hi = check_range(lo, hi)
        with sanitizer.pin_scope("range"):
            return self._range_pinned(lo, hi, materialize=materialize,
                                      backend=backend)

    def _range_pinned(self, lo, hi, *, materialize: bool,
                      backend: str | None) -> RangeResult:
        view = self._pin_view(backend)
        bounds, snaps, offsets = (view.shard_set.boundaries, view.snaps,
                                  view.offsets)
        self._count("ranges", 1)
        lo_rank = int(self._search_view(view, np.asarray([lo]), "left")[0])
        hi_rank = max(int(self._search_view(view, np.asarray([hi]),
                                            "right")[0]), lo_rank)
        keys = payload = None
        if materialize:
            d0 = int(route_keys(bounds, np.float64(lo)))
            d1 = int(route_keys(bounds, np.float64(hi)))
            k_parts, p_parts = [], []
            for d in range(d0, d1 + 1):
                n_d = snaps[d].n_keys
                a = max(int(lo_rank - offsets[d]), 0) if d == d0 else 0
                b = min(int(hi_rank - offsets[d]), n_d) if d == d1 else n_d
                if b <= a:
                    continue
                k_parts.append(snaps[d].table.keys[a:b])
                if snaps[d].payload is not None:
                    p_parts.append(snaps[d].payload[a:b])
            keys = (np.concatenate(k_parts) if k_parts
                    else np.empty(0, np.float64))
            if self.has_payload:
                payload = (np.concatenate(p_parts) if p_parts
                           else np.empty(0))
        return RangeResult(lo=lo, hi=hi, lo_rank=lo_rank, hi_rank=hi_rank,
                           keys=keys, payload=payload)

    def predecessor(self, queries, backend: str | None = None) -> PointResult:
        """Global rank of the largest key <= each query (rightmost
        occurrence), found=False where every key is above the query."""
        with sanitizer.pin_scope("predecessor"):
            view = self._pin_view(backend)
            self._count("predecessors", int(np.size(queries)))
            rank = self._search_view(view, queries, "right") - 1
            return PointResult(rank=rank, found=rank >= 0)

    def successor(self, queries, backend: str | None = None) -> PointResult:
        """Global rank of the smallest key >= each query (leftmost
        occurrence), found=False where every key is below the query."""
        with sanitizer.pin_scope("successor"):
            view = self._pin_view(backend)
            self._count("successors", int(np.size(queries)))
            rank = self._search_view(view, queries, "left")
            found = rank < view.n_keys
            return PointResult(rank=np.where(found, rank, -1), found=found)
