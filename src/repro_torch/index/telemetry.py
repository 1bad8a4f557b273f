"""Telemetry plane + online re-planning: measure the served workload,
re-calibrate the Sec. 6 cost model, hot-swap the plan.

Port of ``repro.index.telemetry`` (host code, copied).  The re-fit inverts
the measured tier curves into the card's ``GPUCostParams`` where the
reference inverts them into its TPU profile.

Two halves close the measure -> re-fit -> re-plan loop that the static
planner (``repro_torch.index.fit``) leaves open:

* :class:`Monitor` -- an append-only named-channel recorder.  The hot path
  is a lock-free ring buffer write (a preallocated slot list plus an atomic
  ``itertools.count`` cursor; the GIL makes the two-step append safe, and a
  racing writer at worst overwrites one slot -- last writer wins, which is
  exactly the semantics a fixed-capacity telemetry ring wants).  Recording
  hooks are threaded through the serving stack:

      DispatchEngine        tier.<small|medium|large>: (batch_size, wall_ns)
      AsyncIndexService     pipeline.queue_depth / pipeline.flush (cause,
                            fused batch size) / pipeline.sojourn (ns)
      ShardedIndexService   service.publish / service.rebalance (wall ns),
                            served.keys (query samples)
      LsmIndexService       lsm.spill / lsm.compaction (wall ns),
                            lsm.read_amp (sampled fan-in)

  :meth:`Monitor.span` times one host section onto ``span.<name>`` as
  ``(start_unix_ns, dur_ns, *tags)``.  The start is on the unix clock, the
  clock ``torch.profiler`` stamps its host events with, and while a profiler
  runs the span also opens a ``record_function`` range of the same name, so
  a trace shows it over the device work it launched.  The spans:

      service.route (n_shards, engine_calls)
                            ShardedIndexService._routed, the read path of
                            lookup, search (and the verbs derived from it)
                            and point: the queries to f64 before the
                            view's one engine call (the call outside)
      service.view_build (shards, segments)
                            ViewTable.assemble: a pinned view's device
                            form, from the shards' forms (each uploaded
                            where it has none yet) end to end on the device
      engine.stage          _DeviceEngine: queries to an f32 host tensor
      engine.cast           _DeviceEngine: the answers copied back to numpy
                            ranks
      lsm.read              LsmIndexService._search_view: the whole fan-in
      lsm.merge             compaction's tombstone kill and sorted merge
      lsm.fit (level)       a run's fit (Snapshot.from_arrays)
      lsm.upload (level)    a run's install and engine build (the upload)
      sharded.insert (keys, shards)
                            ShardedIndexService.insert_many: routing and
                            the Alg. 4 buffer work of the keys up to an
                            auto-publish (the publish outside)
      sharded.publish (shard, refit, segments_before, segments_after)
                            one shard's SnapshotPublisher.publish and install
      tree.flush (refit, refit_on_card)
                            SnapshotPublisher.publish: FITingTree.flush, the
                            merge and re-fit of the dirty segments; the
                            second tag counts those fitted on a CUDA card
      engine.build (keys, segments)
                            ServingHandle: make_engine, the table's device
                            form and its upload

  A span whose tags are known only inside its body sets them there
  (``with span(mon, name) as sp: ...; sp.tag(*tags)``).

  Backends are pluggable: :class:`MemoryBackend` (default, rings only) and
  :class:`JSONLBackend` (same rings; ``flush()`` appends rows recorded since
  the last flush as JSON lines -- IO happens only on flush, never on the
  record path).

* :class:`Replanner` -- the feedback controller.  It re-fits the per-tier
  fixed+marginal cost coefficients from the measured ``tier.*`` samples
  (:func:`repro_torch.core.cost_model.fit_tier_curves`, least squares over
  (batch_size, ns) points), inverts them into calibrated
  ``CostParams``/``GPUCostParams`` (:func:`repro_torch.core.cost_model.
  refit_params`), re-runs ``fit.plan()`` against a reservoir of served keys,
  and -- only when the predicted win over the *observed* batch mix clears a
  hysteresis bar -- hot-swaps the dispatch thresholds, pipeline flush knobs
  and shard count through ``ShardedIndexService.apply_plan`` /
  ``AsyncIndexService.apply_plan``.  Swaps run off the request path (the
  pipeline's maintenance cadence thread calls :meth:`Replanner.step`), and
  both apply paths publish a fresh immutable ``ShardSet`` with one reference
  assignment, so pinned readers never see a torn config.  After a swap the
  thresholds sit at the measured curve crossings, so the next proposal's win
  is ~0 and the hysteresis bar keeps the controller from flapping.

The typed observability surface lives here too: :class:`ServiceMetrics`
(alias :data:`MetricsSnapshot`) is the versioned dataclass tree --
``ServiceMetrics -> ShardMetrics / TierMetrics / PipelineMetrics`` -- that
``metrics()`` returns on every service and on the pipeline, with a
``to_json``/``from_json`` round-trip for dashboards; the legacy ``stats()``
/ ``service_stats()`` dict surfaces are thin deprecated wrappers over it.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import sys
import time

import numpy as np

from repro_torch.analysis.contracts import hot_path
from repro_torch.analysis.sanitizer import make_lock
from repro_torch.core.cost_model import (curve_crossings, fit_tier_curves,
                                         refit_params, tier_cost_curves)

# ------------------------------------------------------------ channel names
# One constant per recording hook, so producers (engine/pipeline/sharded
# hooks) and consumers (Replanner, tier_metrics, dashboards) agree on names.
CH_TIER_PREFIX = "tier."            # + small|medium|large: (batch, wall_ns)
CH_SERVED_KEYS = "served.keys"      # vector rows: sampled query keys
CH_PUBLISH = "service.publish"      # (shards_published, wall_ns)
CH_REBALANCE = "service.rebalance"  # (moved_keys, wall_ns)
CH_QUEUE_DEPTH = "pipeline.queue_depth"  # (queued_queries,)
CH_FLUSH = "pipeline.flush"         # (cause, fused_batch)
CH_SOJOURN = "pipeline.sojourn"     # (ns,) per-request enqueue->resolve
CH_REPLAN = "replan"                # (applied, win, small_max, large_min,
                                    #  n_shards)
CH_SPILL = "lsm.spill"              # (spilled_keys, wall_ns)
CH_COMPACT = "lsm.compaction"       # (runs_merged, merged_keys, wall_ns)
CH_READ_AMP = "lsm.read_amp"        # (fan_in_sources,) sampled per verb
CH_DEVICE_PUBLISH = "device.publish"  # (dirty_shards, bytes, wall_ns, full)
CH_DEVICE_COLLECTIVE = "device.collective"  # (strategy, batch, wall_ns)
CH_DEVICE_OVERFLOW = "device.overflow"  # (overflow_queries,) a2a slack misses
CH_SPAN_PREFIX = "span."            # + span name: (start_unix_ns, dur_ns,
                                    #  *tags)

# device.collective strategy codes
XCHG_ALLGATHER, XCHG_A2A = 0, 1

# pipeline.flush cause codes
FLUSH_THRESHOLD, FLUSH_DEADLINE, FLUSH_DRAIN, FLUSH_INLINE = 0, 1, 2, 3

METRICS_SCHEMA_VERSION = 1

_TIERS = ("small", "medium", "large")


class _Ring:
    """Fixed-capacity append-only ring: the Monitor's hot-path store.

    ``append`` is two steps -- take a cursor ticket (``itertools.count`` is
    atomic under the GIL) and assign the slot -- with no lock.  Concurrent
    appenders can interleave, in which case the later assignment to a slot
    wins; a reader snapshotting mid-append can see a row slightly older than
    the cursor claims.  Both are acceptable for telemetry (bounded loss,
    never a torn Python object: slot assignment is one reference store).

    ``kind`` is fixed by the first record: "scalar" rows are equal-width
    tuples (``values()`` -> an (n, width) array), "vector" rows are small
    arrays (``values()`` -> their 1-D concatenation, e.g. sampled keys).
    """

    __slots__ = ("capacity", "rows", "kind", "_ctr", "total")

    def __init__(self, capacity: int, kind: str):
        self.capacity = int(capacity)
        self.rows: list = [None] * self.capacity
        self.kind = kind
        self._ctr = itertools.count()
        self.total = 0          # rows ever appended (monotonic, approximate
        #                         under racing appends -- telemetry-grade)

    @hot_path
    def append(self, row) -> None:
        i = next(self._ctr)
        self.rows[i % self.capacity] = row
        self.total = i + 1

    def snapshot(self) -> list:
        """Ring contents oldest-first (a shallow copy; rows are immutable)."""
        n = self.total
        if n <= self.capacity:
            return [r for r in self.rows[:n] if r is not None]
        cut = n % self.capacity
        return [r for r in self.rows[cut:] + self.rows[:cut] if r is not None]

    def values(self) -> np.ndarray:
        rows = self.snapshot()
        if self.kind == "vector":
            if not rows:
                return np.empty(0, np.float64)
            return np.concatenate([np.asarray(r, np.float64).ravel()
                                   for r in rows])
        if not rows:
            return np.empty((0, 0), np.float64)
        return np.asarray(rows, np.float64)


class MemoryBackend:
    """In-memory channel store: one ring per channel, nothing else."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity!r}")
        self.capacity = int(capacity)

    def make_ring(self, name: str, kind: str) -> _Ring:
        return _Ring(self.capacity, kind)

    def flush(self, channels: dict[str, _Ring]) -> int:
        """Nothing to persist; returns 0 rows written."""
        return 0

    def close(self, channels: dict[str, _Ring]) -> None:
        pass


class JSONLBackend(MemoryBackend):
    """Ring store + JSON-lines persistence on ``flush()``.

    The record path is identical to :class:`MemoryBackend` (ring write, no
    IO).  ``flush()`` appends every row recorded since the previous flush as
    one JSON line ``{"ch": name, "i": row_index, "v": [...]}``; rows that
    fell off the ring between flushes are skipped and counted in
    ``dropped``.  Not a hot-path sink -- flush from the maintenance cadence
    or at close."""

    def __init__(self, path, capacity: int = 4096):
        super().__init__(capacity)
        self.path = str(path)
        self.dropped = 0
        self._flushed: dict[str, int] = {}
        self._io_lock = make_lock("JSONLBackend._io_lock")

    def flush(self, channels: dict[str, _Ring]) -> int:
        written = 0
        with self._io_lock, open(self.path, "a") as f:
            for name, ring in sorted(channels.items()):
                total = ring.total
                done = self._flushed.get(name, 0)
                if total <= done:
                    continue
                start = max(done, total - ring.capacity)
                self.dropped += start - done
                rows = ring.snapshot()[-(total - start):]
                for i, row in enumerate(rows, start=start):
                    vals = (np.asarray(row, np.float64).ravel().tolist()
                            if ring.kind == "vector" else
                            [float(v) for v in row])
                    f.write(json.dumps({"ch": name, "i": i, "v": vals}) + "\n")
                    written += 1
                self._flushed[name] = total
        return written

    def close(self, channels: dict[str, _Ring]) -> None:
        self.flush(channels)


class Monitor:
    """Append-only named-channel telemetry recorder.

    ``record(name, *values)`` appends one fixed-width row to ``name``'s ring
    (the width is fixed by the first record); ``record_many(name, values)``
    appends one small *array* row (e.g. a sample of served query keys) to a
    vector channel.  Both are lock-free slot writes (see :class:`_Ring`) --
    cheap enough for the lookup hot path -- and both are no-ops while
    ``enabled`` is False, so a monitor can be installed permanently and
    toggled.

    Readers (``channel()``/``channels()``/``count()``) snapshot the rings;
    they are meant for the maintenance thread / dashboards, not the hot
    path.  ``backend`` picks the store: the default :class:`MemoryBackend`
    keeps rings only, :class:`JSONLBackend` also persists on ``flush()``.
    """

    def __init__(self, backend: MemoryBackend | None = None, *,
                 capacity: int | None = None):
        if backend is None:
            backend = MemoryBackend(4096 if capacity is None else capacity)
        elif capacity is not None:
            raise ValueError("pass capacity through the backend when giving "
                             "one explicitly (Monitor(JSONLBackend(path, "
                             "capacity=...)))")
        self.backend = backend
        self.enabled = True
        self._channels: dict[str, _Ring] = {}
        self._make_lock = make_lock("Monitor._make_lock")

    # ------------------------------------------------------------- hot path
    @hot_path
    def record(self, name: str, *values) -> None:
        """Append one scalar row to ``name`` (width fixed by first record)."""
        if not self.enabled:
            return
        ring = self._channels.get(name)
        if ring is None:
            ring = self._make(name, "scalar")
        ring.append(values)

    @hot_path
    def record_many(self, name: str, values) -> None:
        """Append one array row (a *sample*, e.g. served keys) to ``name``."""
        if not self.enabled:
            return
        ring = self._channels.get(name)
        if ring is None:
            ring = self._make(name, "vector")
        ring.append(np.array(values, np.float64).ravel())

    def span(self, name: str, *tags):
        """A context that times its body onto ``span.<name>`` (see
        :class:`_Span`); the shared null context while disabled."""
        return _Span(self, name, tags) if self.enabled else _NULL_SPAN

    def _make(self, name: str, kind: str) -> _Ring:
        with self._make_lock:
            ring = self._channels.get(name)
            if ring is None:
                ring = self.backend.make_ring(name, kind)
                self._channels[name] = ring
        return ring

    # -------------------------------------------------------------- readers
    def channels(self) -> list[str]:
        """Sorted names of every channel that has recorded at least once."""
        return sorted(self._channels)

    def channel(self, name: str) -> np.ndarray:
        """Channel contents, oldest-first: an (n, width) array for scalar
        channels, the 1-D sample concatenation for vector channels; empty
        when the channel does not exist."""
        ring = self._channels.get(name)
        return np.empty((0, 0), np.float64) if ring is None else ring.values()

    def count(self, name: str) -> int:
        """Rows ever recorded on ``name`` (including rows the ring dropped)."""
        ring = self._channels.get(name)
        return 0 if ring is None else ring.total

    def tier_samples(self) -> dict[str, np.ndarray]:
        """The ``tier.*`` channels keyed by bare tier name -- the exact input
        shape :func:`repro_torch.core.cost_model.fit_tier_curves` consumes."""
        out = {}
        for tier in _TIERS:
            rows = self.channel(CH_TIER_PREFIX + tier)
            if rows.size:
                out[tier] = rows
        return out

    # ------------------------------------------------------------ lifecycle
    def flush(self) -> int:
        """Persist through the backend (JSONL appends; memory is a no-op)."""
        return self.backend.flush(self._channels)

    def close(self) -> None:
        self.backend.close(self._channels)

    def clear(self, name: str | None = None) -> None:
        """Drop one channel's ring (or all of them): a fresh measurement
        window, e.g. after a re-plan swap invalidates old samples."""
        with self._make_lock:
            if name is None:
                self._channels = {}
            else:
                self._channels.pop(name, None)


class _NullSpan:
    """The span of a missing or disabled monitor: records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def tag(self, *tags) -> None:
        """Nothing to tag."""


_NULL_SPAN = _NullSpan()


class _Span:
    """One timed host section: on exit it appends ``(start_unix_ns, dur_ns,
    *tags)`` to ``span.<name>``.  The start is ``time.time_ns()``, the clock
    ``torch.profiler`` stamps host events with; the duration is
    ``perf_counter_ns``.  Only while a profiler runs does the span also open
    ``record_function(name)`` (which costs microseconds even with none), and
    torch is looked up, never imported: this module loads without it."""
    __slots__ = ("monitor", "name", "tags", "start", "t0", "range")

    def __init__(self, monitor: Monitor, name: str, tags: tuple):
        self.monitor = monitor
        self.name = name
        self.tags = tags
        self.range = None

    @hot_path
    def __enter__(self):
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is not None and prof._is_profiler_enabled:
            self.range = prof.record_function(self.name)
            self.range.__enter__()
        self.start = time.time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    @hot_path
    def __exit__(self, *exc) -> bool:
        dur = time.perf_counter_ns() - self.t0
        if self.range is not None:
            self.range.__exit__(*exc)
        self.monitor.record(CH_SPAN_PREFIX + self.name, self.start, dur,
                            *self.tags)
        return False

    @hot_path
    def tag(self, *tags) -> None:
        """Set the row's tags where they are known only inside the body."""
        self.tags = tags


@hot_path
def span(monitor: Monitor | None, name: str, *tags):
    """``monitor.span(name, *tags)``, or the shared null context where the
    monitor is None or disabled: a span site then costs a None check."""
    if monitor is None:
        return _NULL_SPAN
    return monitor.span(name, *tags)


# ==================================================================== metrics
@dataclasses.dataclass(frozen=True)
class TierMetrics:
    """One dispatch tier's measured serving profile (from the ``tier.*``
    telemetry channels).  ``fixed_ns``/``per_query_ns`` are the least-squares
    re-fit of the tier's affine cost curve (None until the channel holds
    enough samples at two distinct batch sizes)."""
    tier: str
    calls: int
    queries: int
    mean_batch: float
    mean_ns: float
    fixed_ns: float | None = None
    per_query_ns: float | None = None


@dataclasses.dataclass(frozen=True)
class ShardMetrics:
    """One shard's serving state (the typed form of ``ShardStats``, plus the
    write-side load the rebalancer steers by)."""
    shard: int
    boundary: float
    epoch: int
    n_segments: int
    n_keys: int
    pending_inserts: int
    snapshot_first_key: float = float("nan")
    load: float = 0.0


@dataclasses.dataclass(frozen=True)
class PipelineMetrics:
    """The async front door's counters and current knobs (the typed form of
    ``AsyncIndexService.pipeline_stats()``)."""
    flushes: int = 0
    threshold_flushes: int = 0
    deadline_flushes: int = 0
    drain_flushes: int = 0
    inline_batches: int = 0
    coalesced_queries: int = 0
    max_fused_batch: int = 0
    publishes: int = 0
    maintenance_ticks: int = 0
    queued: int = 0
    flush_threshold: int = 0
    max_wait_us: float = 0.0
    queue_depth: int = 0
    replans: int = 0
    compactions: int = 0


@dataclasses.dataclass(frozen=True)
class LsmMetrics:
    """The tiered write plane's node in the metrics tree (``lsm.*``
    channels + the current ``LevelSet`` shape).

    ``run_counts``/``run_keys`` are per-level (index 0 = freshest spills);
    ``read_amplification`` is the measured mean fan-in width per verb when a
    monitor is attached, else the current worst case ``1 + n_runs``."""
    level_set_version: int
    memtable_keys: int
    memtable_tombstones: int
    memtable_capacity: int
    n_runs: int
    n_levels: int
    run_counts: tuple[int, ...]
    run_keys: tuple[int, ...]
    live_keys: int
    spills: int
    compactions: int
    read_amplification: float


@dataclasses.dataclass(frozen=True)
class DeviceMetrics:
    """The device-sharded serving plane's node in the metrics tree
    (``device.*`` channels + the current ``DeviceShardSet`` shape).

    ``per_device_bytes`` is the resident packed-table footprint per device
    row (sharded arrays only; the replicated router is counted once in
    ``replicated_bytes``).  ``delta_fraction`` is the byte ratio actually
    uploaded vs the full-republish equivalent over the service lifetime --
    the headline number the delta-publish path exists to shrink."""
    device_set_version: int
    n_devices: int
    exchange: str
    s_cap: int
    m_cap: int
    per_device_bytes: tuple[int, ...]
    replicated_bytes: int
    publishes: int
    delta_publishes: int
    full_publishes: int
    bytes_uploaded: int
    bytes_full_equivalent: int
    delta_fraction: float
    allgather_calls: int
    a2a_calls: int
    a2a_overflow_queries: int
    collective_wall_ns: float


@dataclasses.dataclass(frozen=True)
class ServiceMetrics:
    """The one typed, versioned observability snapshot (``MetricsSnapshot``).

    Returned by ``metrics()`` on ``IndexService``, ``ShardedIndexService``
    and ``AsyncIndexService`` (the pipeline fills ``pipeline``); the legacy
    ``stats()``/``service_stats()`` dict surfaces derive from it.
    ``schema_version`` gates consumers across releases; ``plan_revision`` is
    the served ``IndexPlan.revision``, so dashboards can correlate a metric
    shift with the replan that caused it."""
    service: str
    shard_set_version: int
    plan_revision: int
    n_shards: int
    imbalance: float
    rebalances: int
    rebalance_skipped: int
    last_rebalance: dict | None
    pending_inserts: int
    query_counts: dict
    shards: tuple[ShardMetrics, ...] = ()
    tiers: tuple[TierMetrics, ...] = ()
    pipeline: PipelineMetrics | None = None
    lsm: LsmMetrics | None = None
    device: DeviceMetrics | None = None
    schema_version: int = METRICS_SCHEMA_VERSION

    def to_json(self) -> str:
        """Serialize the whole tree; ``from_json`` restores an equal
        snapshot (dataclass equality, NaN-free fields compare equal)."""
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ServiceMetrics":
        d = json.loads(text)
        got = d.pop("schema_version", None)
        if got != METRICS_SCHEMA_VERSION:
            raise ValueError(f"unsupported metrics schema_version {got!r} "
                             f"(this build reads {METRICS_SCHEMA_VERSION})")
        d["shards"] = tuple(ShardMetrics(**s) for s in d.get("shards", ()))
        d["tiers"] = tuple(TierMetrics(**t) for t in d.get("tiers", ()))
        if d.get("pipeline") is not None:
            d["pipeline"] = PipelineMetrics(**d["pipeline"])
        if d.get("lsm") is not None:
            lsm = dict(d["lsm"])
            lsm["run_counts"] = tuple(lsm.get("run_counts", ()))
            lsm["run_keys"] = tuple(lsm.get("run_keys", ()))
            d["lsm"] = LsmMetrics(**lsm)
        if d.get("device") is not None:
            dev = dict(d["device"])
            dev["per_device_bytes"] = tuple(dev.get("per_device_bytes", ()))
            d["device"] = DeviceMetrics(**dev)
        return cls(**d)


MetricsSnapshot = ServiceMetrics   # the tree's public root alias


def tier_metrics(monitor: Monitor | None,
                 min_samples: int = 8) -> tuple[TierMetrics, ...]:
    """Summarize a monitor's ``tier.*`` channels into :class:`TierMetrics`
    rows (empty without a monitor or recorded dispatch traffic)."""
    if monitor is None:
        return ()
    samples = monitor.tier_samples()
    curves = fit_tier_curves(samples, min_samples=min_samples)
    out = []
    for tier in _TIERS:
        rows = samples.get(tier)
        if rows is None:
            continue
        fit = curves.get(tier)
        out.append(TierMetrics(
            tier=tier,
            calls=monitor.count(CH_TIER_PREFIX + tier),
            queries=int(rows[:, 0].sum()),
            mean_batch=float(rows[:, 0].mean()),
            mean_ns=float(rows[:, 1].mean()),
            fixed_ns=None if fit is None else fit[0],
            per_query_ns=None if fit is None else fit[1]))
    return tuple(out)


# ================================================================== replanner
class Replanner:
    """Feedback controller: measured telemetry -> re-calibrated cost model ->
    hot-swapped :class:`repro_torch.index.fit.IndexPlan`.

    ``service`` is an ``IndexService`` or ``ShardedIndexService`` carrying a
    ``monitor`` (or pass one explicitly); attach to an ``AsyncIndexService``
    via its ``replanner=`` argument and the maintenance cadence thread calls
    :meth:`step` off the request path.

    One :meth:`replan` pass:

    1. re-fit the per-tier (fixed, marginal) cost coefficients from the
       measured ``tier.*`` samples; tiers without enough samples keep the
       modeled curve, so partial telemetry degrades gracefully;
    2. invert the merged curves into calibrated ``CostParams`` /
       ``GPUCostParams`` and re-run ``fit.plan()`` over a reservoir of
       *served* keys (falling back to the stored snapshots when no key
       samples were recorded) with the observed range fraction folded in;
    3. score the fresh thresholds against the served plan's over the
       *observed* batch-size mix under the merged curves.  Only a predicted
       mean-cost win above ``hysteresis`` (a fraction, e.g. 0.15 = 15%)
       applies the swap -- and because an applied swap moves the thresholds
       onto the measured crossings, the next pass predicts ~0 win, so the
       controller cannot flap under measurement noise;
    4. apply through ``service.apply_plan`` (new engine opts + fresh
       ``ShardSet`` swap; shard-count changes rebuild the writers) and
       ``pipeline.apply_plan`` (flush knobs), bumping ``plan.revision`` via
       ``IndexPlan.replace`` so the change is auditable.

    An infeasible re-plan (the calibrated model proves the original budget
    unachievable on this host) falls back to re-tuning around the currently
    served error instead of killing the maintenance loop.  The serving
    backend family is never changed by a replan: moving the thresholds
    already re-routes the traffic, and keeping ``dispatch`` keeps the
    telemetry flowing.
    """

    def __init__(self, service, monitor: Monitor | None = None, *,
                 interval_s: float = 5.0, hysteresis: float = 0.15,
                 min_tier_samples: int = 8, max_plan_keys: int = 65_536,
                 reshard: bool = True):
        monitor = monitor or getattr(service, "monitor", None)
        if monitor is None:
            raise ValueError("Replanner needs a Monitor: build the service "
                             "with monitor=Monitor() (so the dispatch tiers "
                             "record) or pass one explicitly")
        if hysteresis < 0:
            raise ValueError(f"hysteresis must be >= 0, got {hysteresis!r}")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s!r}")
        self.service = service
        self.monitor = monitor
        self.interval_s = float(interval_s)
        self.hysteresis = float(hysteresis)
        self.min_tier_samples = int(min_tier_samples)
        self.max_plan_keys = int(max_plan_keys)
        self.reshard = bool(reshard)
        self.pipeline = None          # bound by AsyncIndexService(replanner=)
        self.checks = 0               # proposals evaluated
        self.replans = 0              # proposals applied
        self.last_win: float | None = None
        self._last_step: float | None = None

    # ------------------------------------------------------------- measured
    def measured_curves(self) -> dict[str, tuple[float, float]]:
        """Per-tier least-squares (fixed_ns, per_query_ns) from telemetry."""
        return fit_tier_curves(self.monitor.tier_samples(),
                               min_samples=self.min_tier_samples)

    def observed_batch_sizes(self) -> np.ndarray:
        """The served batch-size mix (every recorded dispatch call)."""
        sizes = [rows[:, 0] for rows in self.monitor.tier_samples().values()]
        if sizes:
            return np.concatenate(sizes).astype(np.int64)
        return np.empty(0, np.int64)

    def served_keys(self) -> np.ndarray:
        """Reservoir of served query keys (the ``served.keys`` samples),
        falling back to the stored snapshot keys when none were recorded --
        a re-plan always has *some* representative key set."""
        keys = self.monitor.channel(CH_SERVED_KEYS)
        if keys.size == 0:
            handles = getattr(self.service, "handles", None)
            if handles is None:
                handles = (self.service.handle,)
            keys = np.concatenate([h.current().table.keys for h in handles])
        keys = np.asarray(keys, np.float64).ravel()
        if keys.size > self.max_plan_keys:
            stride = int(np.ceil(keys.size / self.max_plan_keys))
            keys = keys[::stride]
        return keys

    # ------------------------------------------------------------- proposal
    def propose(self):
        """One controller pass without applying: returns ``(new_plan, win)``
        or ``None`` when there is nothing to propose yet (no measured tier
        samples or no served keys)."""
        # lazy: fit pulls in the planner stack; keep telemetry import-light
        import dataclasses as dc

        from .fit import FitSpec, InfeasibleSpecError
        from .fit import plan as fit_plan

        cur = self.service.plan
        measured = self.measured_curves()
        if not measured:
            return None
        snap = self.service.metrics()
        n_segments = max(1, sum(s.n_segments for s in snap.shards))
        eff_error = max(1, cur.error - cur.buffer_size)
        spec0 = cur.spec if cur.spec is not None else FitSpec(error=cur.error)
        model = tier_cost_curves(eff_error, n_segments, spec0.cpu_params,
                                 spec0.gpu_params,
                                 range_fraction=spec0.range_fraction,
                                 scan_rows=spec0.range_scan_rows)
        curves = {**model, **measured}

        cpu2, gpu2 = refit_params(curves, eff_error, n_segments,
                                  spec0.cpu_params, spec0.gpu_params)
        qc = snap.query_counts
        shaped = qc.get("points", 0) + qc.get("ranges", 0)
        rf = (min(qc.get("ranges", 0) / shaped, 0.99) if shaped > 0
              else spec0.range_fraction)
        spec2 = dc.replace(spec0, cpu_params=cpu2, gpu_params=gpu2,
                           range_fraction=rf)
        keys = self.served_keys()
        if keys.size == 0:
            return None
        try:
            fresh = fit_plan(keys, spec2)
        except InfeasibleSpecError:
            # calibration proved the original budget unachievable here:
            # re-tune around the served error rather than dying
            spec2 = dc.replace(spec2, latency_budget_ns=None,
                               storage_budget_bytes=None, error=cur.error)
            fresh = fit_plan(keys, spec2)

        mix = self.observed_batch_sizes()
        if mix.size == 0:
            mix = np.asarray(spec2.batch_sizes or (1, 64, 4096), np.int64)
        old_sm, old_lm = cur.small_max, cur.large_min
        if old_sm is None:    # trivial plan: the engine derived model curves
            old_sm, old_lm = curve_crossings(model)
        win = self._mix_win(curves, mix, (old_sm, old_lm),
                            (fresh.small_max, fresh.large_min))

        n_shards = fresh.n_shards if self.reshard else cur.n_shards
        new_plan = cur.replace(
            error=fresh.error, n_shards=n_shards,
            buffer_size=fresh.buffer_size,
            small_max=fresh.small_max, large_min=fresh.large_min,
            publish_every=(fresh.publish_every if fresh.buffer_size > 0
                           else None),
            flush_threshold=fresh.flush_threshold,
            max_wait_us=fresh.max_wait_us, queue_depth=fresh.queue_depth,
            objective=fresh.objective, budget=fresh.budget,
            hardware=fresh.hardware, n_keys=fresh.n_keys,
            candidates=fresh.candidates, spec=spec2)
        return new_plan, win

    @staticmethod
    def _mix_win(curves, mix, old_th, new_th) -> float:
        """Predicted fractional mean-cost win of routing the observed batch
        mix with ``new_th`` instead of ``old_th`` under ``curves``."""
        def mean_cost(small_max, large_min):
            total = 0.0
            for b in mix:
                b = int(b)
                tier = ("small" if b <= small_max else
                        "medium" if b < large_min else "large")
                fixed, per = curves[tier]
                total += fixed + per * b
            return total / max(len(mix), 1)

        old_cost = mean_cost(*old_th)
        new_cost = mean_cost(*new_th)
        return (old_cost - new_cost) / old_cost if old_cost > 0 else 0.0

    # ---------------------------------------------------------------- apply
    def replan(self, force: bool = False):
        """One full controller pass: propose, gate on hysteresis, apply.

        Returns the newly served plan when a swap happened, else ``None``
        (nothing measured yet, or the predicted win did not clear the bar;
        ``force=True`` skips the bar, not the measurement)."""
        proposal = self.propose()
        if proposal is None:
            return None
        new_plan, win = proposal
        self.checks += 1
        self.last_win = win
        if not force and win <= self.hysteresis:
            self.monitor.record(CH_REPLAN, 0.0, win,
                                float(new_plan.small_max or -1),
                                float(new_plan.large_min or -1),
                                float(new_plan.n_shards))
            return None
        self.service.apply_plan(new_plan, reshard=self.reshard)
        served = self.service.plan       # apply may clamp (e.g. shard count)
        pipe = self.pipeline
        if pipe is not None:
            pipe.apply_plan(served)
        self.replans += 1
        self.monitor.record(CH_REPLAN, 1.0, win,
                            float(served.small_max or -1),
                            float(served.large_min or -1),
                            float(served.n_shards))
        return served

    def step(self, now: float | None = None):
        """Rate-limited :meth:`replan` -- the maintenance cadence hook.  At
        most one controller pass per ``interval_s``; cheap to call often."""
        now = time.monotonic() if now is None else now
        if self._last_step is not None \
                and now - self._last_step < self.interval_s:
            return None
        self._last_step = now
        return self.replan()
