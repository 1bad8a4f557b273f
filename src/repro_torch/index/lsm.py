"""LSM-style tiered write plane: memtable -> sorted learned runs -> compaction.

The paper's Alg. 4 delta-buffer absorbs *moderate* insert rates: every
``publish()`` re-segments the whole tree, so a write-dominated workload pays a
full re-fit per buffer fill and read latency degrades with ingest.  This
module adds the tier structure: writes land in a small mutable
**memtable**, full memtables **spill** into immutable sorted
**runs** -- each an error-bounded ``SegmentTable`` wrapped in the existing
``Snapshot``/``ServingHandle`` epoch machinery -- and a size-tiered
**Compactor** merges runs in the background, re-fitting segments strictly off
the serving path.

    writes -->  Memtable (bounded, sorted in place)
                   | spill (full)                       newest
                   v                                      |
                Run[L0] Run[L0] ... --merge-->  Run[L1] ...  Run[Lk]
                                                          |
                                                        oldest

**One atomic manifest.**  The whole level structure -- memtable reference plus
the newest-first run list -- lives in one immutable versioned
:class:`LevelSet`, swapped with a single reference assignment exactly like
``ShardSet``: readers pin ``self._level_set`` once per verb and keep a fully
consistent view while spills and compactions publish new manifests next to
them.  A spill never mutates the memtable a pinned reader is looking at; it
*abandons* it (the new ``LevelSet`` carries a fresh empty memtable) so the old
view stays frozen in place.

**Fan-in reads.**  All query verbs generalize the cross-shard leftmost-rank
merge: a global rank is the sum of per-source ``searchsorted`` ranks over the
memtable and every live run, minus the occurrences *shadowed* by newer
tombstones.  Deletes append a tombstone key that hides every occurrence in
strictly older runs; upserts are an atomic delete+insert, so the newest level
wins.  Shadow corrections are precomputed when a ``LevelSet`` is built
(``Run.shadow_keys`` / ``Run.shadow_cum`` prefix counts), which keeps the verb
path to pure vectorized ``searchsorted`` arithmetic -- exact because all
occurrences of a tombstoned key compare equal, so side semantics are
preserved.

Plan integration: ``fit.plan`` resolves ``write_mode="lsm"`` for write-heavy
specs (or when ``error`` leaves no room for an Alg. 4 buffer) and sizes
``memtable_capacity`` / ``level_fanout``; ``open_index`` then builds this
service.  ``publish()`` is the maintenance verb the async pipeline cadence
already drives: it spills an overfull memtable and runs one compaction step,
returning a dict (``{}`` when idle) the pipeline counts as publish activity.

Port of ``repro.index.lsm`` (host code, copied).  Raw-knob services default
to the ``cuda`` backend, so every run serves on the CUDA card unless the
caller names another backend or passes ``engine_opts={"cuda": {"device":
"cpu"}}``.  A verb fans out to one engine call per live run -- on the card
one launch of the fused search kernel per run, the batch copied in and out
once per run.  A run's device form is uploaded when the run is built (the
spill or merge builds its default engine, so no reader pays the upload) and
is freed with the last manifest or pinned read view that holds the run:
``_with_shadows`` re-wraps runs but shares their handles, so a compaction
leaves nothing of the replaced runs behind once their readers return.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import TYPE_CHECKING, NamedTuple, Sequence

import numpy as np

from repro_torch.analysis import sanitizer

from .engine import inject_monitor
from .query import (PointResult, RangeResult, check_range, check_side,
                    merge_sorted_sources)
from .snapshot import ServingHandle, Snapshot
from .telemetry import (CH_COMPACT, CH_READ_AMP, CH_SPILL, LsmMetrics,
                        Monitor, ServiceMetrics, span, tier_metrics)

if TYPE_CHECKING:  # runtime import is lazy (fit builds services via plans)
    from .fit import IndexPlan

DEFAULT_MEMTABLE_CAPACITY = 4096
DEFAULT_LEVEL_FANOUT = 4

# every Nth verb call records its fan-in width (CH_READ_AMP); amortized like
# the sharded service's served-keys sampling
_AMP_SAMPLE_EVERY = 8

_EMPTY_KEYS = np.empty(0, dtype=np.float64)
_ZERO_CUM = np.zeros(1, dtype=np.int64)


def _sorted_unique(values) -> np.ndarray:
    arr = np.asarray(sorted(values), dtype=np.float64)
    return arr if arr.size else _EMPTY_KEYS


class MemtableFullError(RuntimeError):
    """Insert hit a full memtable outside the service's spill loop."""


# ---------------------------------------------------------------------------
# memtable
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MemView:
    """Immutable point-in-time view of a memtable (the spill/read interface).

    ``keys`` is sorted ascending; ``tombstones`` is sorted unique.  Arrays are
    frozen copies -- safe to hand to a ``SegmentTable`` or hold across a
    concurrent writer.
    """
    keys: np.ndarray
    payload: np.ndarray | None
    tombstones: np.ndarray
    version: int

    def __post_init__(self) -> None:
        object.__setattr__(self, "keys", sanitizer.published_array(self.keys))
        object.__setattr__(self, "tombstones",
                           sanitizer.published_array(self.tombstones))
        if self.payload is not None:
            object.__setattr__(self, "payload",
                               sanitizer.published_array(self.payload))

    @property
    def n_keys(self) -> int:
        return int(self.keys.size)


class Memtable:
    """Bounded sorted in-place write buffer: the mutable L0 of the LSM tree.

    Keys live in a preallocated float64 buffer kept sorted by memmove-style
    slice shifts (O(capacity) per write -- the capacity is small by design,
    sized by the planner so a spill fires every few hundred ms of expected
    ingest).  Deletes remove live occurrences *and* record the key in a
    tombstone set that shadows older runs until compaction retires it.

    Readers call :meth:`view` for an immutable ``MemView``; the view is
    cached and only rebuilt after a mutation, so a read-heavy phase costs one
    copy total.  All mutators take ``Memtable._lock``; the service additionally
    serializes writers under its own write lock, so this lock only guards
    against view() racing a mutator.
    """

    def __init__(self, capacity: int,
                 payload_dtype: np.dtype | None = None) -> None:
        if capacity < 2:
            raise ValueError(f"memtable capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        self._lock = sanitizer.make_lock("Memtable._lock")
        self._buf = np.empty(self.capacity, dtype=np.float64)
        self._pbuf = (None if payload_dtype is None
                      else np.empty(self.capacity, dtype=payload_dtype))
        self._n = 0
        self._tombs: set[float] = set()
        self._version = 0
        self._cached_view: MemView | None = None

    # -- occupancy ---------------------------------------------------------
    @property
    def size(self) -> int:
        return self._n

    @property
    def tombstone_count(self) -> int:
        return len(self._tombs)

    @property
    def room(self) -> int:
        return self.capacity - self._n

    def is_full(self) -> bool:
        """Spill trigger: key buffer full, or the tombstone set has grown to
        capacity (tombstones occupy the spill run, so they count)."""
        return self._n >= self.capacity or len(self._tombs) >= self.capacity

    def is_empty(self) -> bool:
        return self._n == 0 and not self._tombs

    # -- mutators ----------------------------------------------------------
    def insert(self, key: float, value=None) -> None:
        with self._lock:
            self._insert_locked(key, value)

    def insert_many(self, keys, values=None) -> None:
        """Vectorized batch insert (one stable two-way merge, not N shifts).

        The batch must fit in the remaining room; the service chunks larger
        batches around spills.
        """
        with self._lock:
            batch = np.asarray(keys, dtype=np.float64).ravel()
            if batch.size == 0:
                return
            if self._n + batch.size > self.capacity:
                raise MemtableFullError(
                    f"batch of {batch.size} overflows memtable "
                    f"({self._n}/{self.capacity} used)")
            order = np.argsort(batch, kind="stable")
            incoming = batch[order]
            current = self._buf[:self._n]
            slots = (np.searchsorted(current, incoming, side="right")
                     + np.arange(incoming.size))
            merged = np.empty(self._n + incoming.size, dtype=np.float64)
            mask = np.zeros(merged.size, dtype=bool)
            mask[slots] = True
            merged[mask] = incoming
            merged[~mask] = current
            if self._pbuf is not None:
                vals = (np.zeros(batch.size, dtype=self._pbuf.dtype)
                        if values is None
                        else np.asarray(values).ravel()[order])
                pmerged = np.empty(merged.size, dtype=self._pbuf.dtype)
                pmerged[mask] = vals
                pmerged[~mask] = self._pbuf[:self._n]
                self._pbuf[:merged.size] = pmerged
            self._buf[:merged.size] = merged
            self._n = merged.size
            self._dirty_locked()

    def delete(self, key: float) -> int:
        """Remove live occurrences of ``key`` here and tombstone it for every
        strictly older run.  Returns the number of memtable occurrences
        removed (the shadowed run occurrences are unknowable without a
        read)."""
        with self._lock:
            return self._delete_locked(key)

    def upsert(self, key: float, value=None) -> None:
        """Atomic delete+insert: afterwards exactly one live occurrence of
        ``key`` exists across all levels, carrying ``value``."""
        with self._lock:
            self._delete_locked(key)
            self._insert_locked(key, value)

    def _insert_locked(self, key: float, value) -> None:
        if self._n >= self.capacity:
            raise MemtableFullError(
                f"memtable full ({self.capacity} keys); spill first")
        k = float(key)
        pos = int(np.searchsorted(self._buf[:self._n], k, side="right"))
        self._buf[pos + 1:self._n + 1] = self._buf[pos:self._n].copy()
        self._buf[pos] = k
        if self._pbuf is not None:
            self._pbuf[pos + 1:self._n + 1] = self._pbuf[pos:self._n].copy()
            self._pbuf[pos] = 0 if value is None else value
        self._n += 1
        self._dirty_locked()

    def _delete_locked(self, key: float) -> int:
        k = float(key)
        lo = int(np.searchsorted(self._buf[:self._n], k, side="left"))
        hi = int(np.searchsorted(self._buf[:self._n], k, side="right"))
        removed = hi - lo
        if removed:
            self._buf[lo:self._n - removed] = self._buf[hi:self._n].copy()
            if self._pbuf is not None:
                self._pbuf[lo:self._n - removed] = \
                    self._pbuf[hi:self._n].copy()
            self._n -= removed
        self._tombs.add(k)
        self._dirty_locked()
        return removed

    def _dirty_locked(self) -> None:
        self._version += 1
        self._cached_view = None

    # -- readers -----------------------------------------------------------
    def view(self) -> MemView:
        """Immutable snapshot of the current contents (cached until the next
        mutation)."""
        cached = self._cached_view
        if cached is not None:
            return cached
        with self._lock:
            cached = self._cached_view
            if cached is None:
                cached = MemView(
                    keys=self._buf[:self._n].copy(),
                    payload=(None if self._pbuf is None
                             else self._pbuf[:self._n].copy()),
                    tombstones=_sorted_unique(self._tombs),
                    version=self._version)
                self._cached_view = cached
            return cached


# ---------------------------------------------------------------------------
# runs and the level manifest
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Run:
    """One immutable sorted learned run: a published ``Snapshot`` plus the
    tombstones it carries and the shadow corrections applied *to* it.

    ``tombstones`` are the deletes this run absorbed when it was spilled or
    merged; they hide matching occurrences in every **strictly older** run (a
    key re-inserted after the delete spills into this same run and is not its
    own victim).  ``shadow_keys``/``shadow_cum`` are the precomputed inverse:
    the sorted unique tombstone keys of all strictly *newer* runs, with
    ``shadow_cum[i]`` = occurrences of ``shadow_keys[:i]`` in this run --
    recomputed by :func:`_with_shadows` whenever the run list changes, so the
    verb path subtracts shadowed ranks with two ``searchsorted`` calls.
    """
    snapshot: Snapshot
    handle: ServingHandle
    tombstones: np.ndarray
    level: int
    run_id: int
    shadow_keys: np.ndarray
    shadow_cum: np.ndarray

    def __post_init__(self) -> None:
        object.__setattr__(self, "tombstones",
                           sanitizer.published_array(self.tombstones))
        object.__setattr__(self, "shadow_keys",
                           sanitizer.published_array(self.shadow_keys))
        object.__setattr__(self, "shadow_cum",
                           sanitizer.published_array(self.shadow_cum))

    @property
    def n_keys(self) -> int:
        return self.snapshot.n_keys

    @property
    def n_shadowed(self) -> int:
        """Occurrences in this run hidden by newer runs' tombstones."""
        return int(self.shadow_cum[-1])

    @property
    def live_keys(self) -> int:
        return self.n_keys - self.n_shadowed


@dataclasses.dataclass(frozen=True)
class LevelSet:
    """The atomic level manifest: one memtable + runs ordered newest-first.

    Swapped whole with a single reference assignment (``ShardSet``
    discipline): a reader that pinned version N keeps N's memtable object and
    run tuple even while a spill/compaction publishes N+1 -- the memtable in
    an old manifest is *abandoned* by the spill, never mutated, so the pinned
    view stays internally consistent.
    """
    version: int
    memtable: Memtable
    runs: tuple[Run, ...]

    @property
    def n_runs(self) -> int:
        return len(self.runs)

    def run_levels(self) -> tuple[int, ...]:
        """Distinct levels present, ascending (0 = freshest spills)."""
        return tuple(sorted({r.level for r in self.runs}))

    def runs_per_level(self) -> tuple[int, ...]:
        """Run count for each level from 0 through the deepest occupied."""
        if not self.runs:
            return ()
        deepest = max(r.level for r in self.runs)
        counts = [0] * (deepest + 1)
        for r in self.runs:
            counts[r.level] += 1
        return tuple(counts)

    def keys_per_level(self) -> tuple[int, ...]:
        if not self.runs:
            return ()
        deepest = max(r.level for r in self.runs)
        totals = [0] * (deepest + 1)
        for r in self.runs:
            totals[r.level] += r.n_keys
        return tuple(totals)


def _occurrence_cum(run_keys: np.ndarray, probe: np.ndarray) -> np.ndarray:
    """Prefix occurrence counts: out[i] = occurrences of probe[:i] in
    run_keys (length ``probe.size + 1``, out[0] == 0)."""
    if probe.size == 0:
        return _ZERO_CUM
    lo = np.searchsorted(run_keys, probe, side="left")
    hi = np.searchsorted(run_keys, probe, side="right")
    out = np.empty(probe.size + 1, dtype=np.int64)
    out[0] = 0
    np.cumsum(hi - lo, out=out[1:])
    return out


def _with_shadows(runs: Sequence[Run]) -> tuple[Run, ...]:
    """Recompute every run's shadow arrays for a newest-first ordering.

    Each run is shadowed by the union of tombstones of all strictly newer
    runs.  Returns fresh ``Run`` objects (``dataclasses.replace``) sharing the
    snapshots and serving handles -- engines stay warm across reshadowing.
    """
    out: list[Run] = []
    newer_tombs: set[float] = set()
    for run in runs:
        if newer_tombs:
            shadow_keys = _sorted_unique(newer_tombs)
            shadow_cum = _occurrence_cum(run.snapshot.table.keys, shadow_keys)
        else:
            shadow_keys, shadow_cum = _EMPTY_KEYS, _ZERO_CUM
        out.append(dataclasses.replace(run, shadow_keys=shadow_keys,
                                       shadow_cum=shadow_cum))
        newer_tombs.update(run.tombstones.tolist())
    return tuple(out)


class _LsmView(NamedTuple):
    """One pinned, internally consistent read view (one verb invocation)."""
    level_set: LevelSet
    mem: MemView
    engines: tuple
    # per-run memtable-tombstone corrections: (extra_keys, extra_cum), the
    # live-memtable tombstones not already in the run's shadow_keys
    extras: tuple
    total: int  # live occurrences across all sources


# ---------------------------------------------------------------------------
# compactor
# ---------------------------------------------------------------------------
class Compactor:
    """Size-tiered background merge: K runs on one level -> one run a level
    deeper, re-fit off the serving path.

    ``step()`` picks the shallowest level holding >= ``fanout`` runs, merges
    the whole group under ``Compactor._lock`` (the expensive part: tombstone
    application, stable key merge, ``SegmentTable.from_keys`` re-fit) without
    touching the service write lock, then swaps the manifest in a brief
    critical section that reconciles any runs spilled meanwhile.  Tombstones
    merging into the oldest run are retired -- nothing older exists for them
    to shadow.  ``start()`` runs steps on a daemon cadence for standalone use;
    under the async pipeline the maintenance loop drives ``service.publish()``
    which calls ``step()`` directly.
    """

    def __init__(self, service: "LsmIndexService", *, fanout: int = 4,
                 interval_s: float = 0.05) -> None:
        self.service = service
        self.fanout = max(2, int(fanout))
        self.interval_s = float(interval_s)
        self._lock = sanitizer.make_lock("Compactor._lock")
        self.compactions = 0
        self._thread: threading.Thread | None = None
        self._stop_event = threading.Event()
        self._fatal: BaseException | None = None
        # test seam: called once per merged group inside the (slow) merge
        # section, before the manifest swap -- lets the race test widen the
        # compaction window deterministically
        self._merge_hook = None

    def pick(self, runs: Sequence[Run]) -> list[Run] | None:
        """The merge group: all runs on the shallowest level with >= fanout
        of them (newest-first order preserved), or None."""
        by_level: dict[int, list[Run]] = {}
        for r in runs:
            by_level.setdefault(r.level, []).append(r)
        for level in sorted(by_level):
            if len(by_level[level]) >= self.fanout:
                return by_level[level]
        return None

    def step(self) -> int:
        """One compaction pass; returns the number of runs merged (0 =
        nothing to do)."""
        with self._lock:
            svc = self.service
            level_set = svc._level_set
            group = self.pick(level_set.runs)
            if group is None:
                return 0
            # valid at swap time too: concurrent spills only *prepend* newer
            # runs, so "nothing is older than the group's tail" cannot flip
            drop_tombstones = group[-1] is level_set.runs[-1]
            if self._merge_hook is not None:
                self._merge_hook()
            merged = svc._build_merged_run(group, drop_tombstones)
            svc._swap_merged(group, merged)
            self.compactions += 1
            return len(group)

    # -- background cadence ------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop_event.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lsm-compactor")
        self._thread.start()

    def stop(self) -> None:
        self._stop_event.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)
            self._thread = None
        if self._fatal is not None:
            fatal, self._fatal = self._fatal, None
            raise fatal

    def _loop(self) -> None:
        while not self._stop_event.wait(self.interval_s):
            try:
                self.step()
            except BaseException as exc:  # surfaced by stop()
                self._fatal = exc
                return


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------
class LsmIndexService:
    """Tiered write-optimized serving: the LSM counterpart to the per-tree
    Alg. 4 buffer, behind the same verb surface as ``IndexService`` /
    ``ShardedIndexService``.

    Construction mirrors the sharded service: pass the raw knobs *or* a
    resolved ``IndexPlan`` (``write_mode="lsm"``), not both.  Bulk keys load
    into a single run at the level matching their size (so the planner's
    fanout policy doesn't immediately merge a large base run with fresh
    spills); subsequent writes flow memtable -> spill -> compaction.

    Thread contract: all writers serialize on ``_write_lock``; readers are
    lock-free against the manifest (one pinned ``LevelSet`` reference per
    verb) and only touch per-run handle locks when an engine is first built.
    ``publish()`` is safe to drive from the async pipeline's maintenance
    thread concurrently with both.
    """

    def __init__(self, keys=None, error: int | None = None, *,
                 plan: "IndexPlan | None" = None,
                 memtable_capacity: int | None = None,
                 level_fanout: int | None = None,
                 payload=None, mode: str = "paper",
                 backend: str | None = None,
                 engine_opts: dict[str, dict] | None = None,
                 publish_every: int | None = None,
                 assume_sorted: bool = False,
                 monitor: Monitor | None = None,
                 background_compaction: bool = False,
                 compact_interval_s: float = 0.05,
                 # accepted for knob-compat with the other services
                 # (open_index passes through user kwargs); inert here
                 skew_threshold: float = 2.0, pending_weight: float = 1.0,
                 auto_rebalance: bool = False) -> None:
        from .fit import IndexPlan
        raw = {"error": error, "backend": backend,
               "publish_every": publish_every,
               "memtable_capacity": memtable_capacity,
               "level_fanout": level_fanout}
        if plan is None:
            if error is None:
                raise TypeError("pass error=... (raw knobs) or plan=...")
            plan = IndexPlan.from_knobs(
                error=error, backend=backend or "cuda",
                publish_every=publish_every, write_mode="lsm",
                memtable_capacity=memtable_capacity,
                level_fanout=level_fanout)
        else:
            clashing = sorted(k for k, v in raw.items() if v is not None)
            if clashing:
                raise TypeError(
                    f"pass either the raw knobs or plan=, not both -- the "
                    f"plan already fixes {', '.join(clashing)}")
        self.plan = plan
        self.error = int(plan.error)
        self.memtable_capacity = int(plan.memtable_capacity
                                     or DEFAULT_MEMTABLE_CAPACITY)
        self.level_fanout = int(plan.level_fanout or DEFAULT_LEVEL_FANOUT)
        self.default_backend = plan.backend
        self.monitor = monitor
        self._mode = mode
        self._engine_opts = inject_monitor(plan.merge_engine_opts(
            engine_opts), monitor)
        self._write_lock = sanitizer.make_rlock("LsmIndexService._write_lock")
        self._counts_lock = sanitizer.make_lock(
            "LsmIndexService._counts_lock")
        self._query_counts = {"points": 0, "ranges": 0, "counts": 0,
                              "predecessors": 0, "successors": 0,
                              "searches": 0}
        self._amp_counter = itertools.count()
        self._run_seq = 0
        self._spills = 0
        self.compactor = Compactor(self, fanout=self.level_fanout,
                                   interval_s=compact_interval_s)

        base = np.asarray([] if keys is None else keys,
                          dtype=np.float64).ravel()
        pay = None
        if payload is not None:
            pay = np.asarray(payload).ravel()
            if pay.size != base.size:
                raise ValueError(
                    f"payload length {pay.size} != key length {base.size}")
        self.has_payload = payload is not None
        self._payload_dtype = None if pay is None else pay.dtype
        if base.size and not assume_sorted:
            order = np.argsort(base, kind="stable")
            base = base[order]
            if pay is not None:
                pay = pay[order]
        runs: tuple[Run, ...] = ()
        if base.size:
            runs = (self._make_run(base, pay,
                                   level=self._bulk_level(base.size),
                                   tombstones=_EMPTY_KEYS),)
        self._level_set = LevelSet(version=1, memtable=self._fresh_memtable(),
                                   runs=runs)
        if background_compaction:
            self.compactor.start()

    # -- construction helpers ---------------------------------------------
    @classmethod
    def from_plan(cls, keys, plan: "IndexPlan", **service_kwargs
                  ) -> "LsmIndexService":
        """Build from a resolved ``IndexPlan`` (``fit.open_index`` path)."""
        return cls(keys, plan=plan, **service_kwargs)

    def _fresh_memtable(self) -> Memtable:
        return Memtable(self.memtable_capacity,
                        payload_dtype=self._payload_dtype)

    def _bulk_level(self, n_keys: int) -> int:
        """Level whose size class fits a bulk run: capacity * fanout^L."""
        level, size_class = 0, self.memtable_capacity
        while n_keys > size_class:
            level += 1
            size_class *= self.level_fanout
        return level

    def _make_run(self, run_keys: np.ndarray, run_payload, *, level: int,
                  tombstones: np.ndarray) -> Run:
        """Fit + publish one immutable run (keys already sorted).  Shadow
        arrays start empty; ``_with_shadows`` fills them when the run joins a
        manifest."""
        self._run_seq += 1
        epoch = self._run_seq
        # an empty-key run (a spill of pure deletes) still publishes: its
        # tombstones keep shadowing older runs without live keys of its own
        with span(self.monitor, "lsm.fit", level):
            snapshot = Snapshot.from_arrays(run_keys, self.error,
                                            payload=run_payload, epoch=epoch,
                                            mode=self._mode,
                                            assume_sorted=True)
        handle = ServingHandle(self._engine_opts)
        with span(self.monitor, "lsm.upload", level):
            handle.install(snapshot)
            # build the default engine here, on the write/compaction path, so
            # the first reader against a fresh run never pays engine
            # construction (and the table's upload to the device)
            handle.engine(self.default_backend)
        return Run(snapshot=snapshot, handle=handle, tombstones=tombstones,
                   level=level, run_id=epoch, shadow_keys=_EMPTY_KEYS,
                   shadow_cum=_ZERO_CUM)

    # -- manifest access ---------------------------------------------------
    def _pin_level_set(self) -> LevelSet:
        level_set = self._level_set
        sanitizer.observe_pin(level_set.version)
        return level_set

    @property
    def level_set(self) -> LevelSet:
        """The current manifest (itself immutable; safe to hold)."""
        return self._pin_level_set()

    @property
    def version(self) -> int:
        return self._pin_level_set().version

    # -- write path --------------------------------------------------------
    def _writable_memtable(self) -> Memtable:
        """Current memtable with room for at least one write; spills first
        when full.  Caller holds ``_write_lock``."""
        level_set = self._level_set
        if level_set.memtable.is_full():
            level_set = self._spill_locked(level_set)
        return level_set.memtable

    def insert(self, key: float, value=None) -> None:
        if value is not None and not self.has_payload:
            raise ValueError("service built without payload; insert(key) only")
        with self._write_lock:
            self._writable_memtable().insert(key, value)

    def insert_many(self, keys, values=None) -> int:
        """Bulk ingest: vectorized memtable merges, spilling between chunks.
        Returns the number of keys ingested."""
        batch = np.asarray(keys, dtype=np.float64).ravel()
        vals = None
        if values is not None:
            if not self.has_payload:
                raise ValueError(
                    "service built without payload; insert_many(keys) only")
            vals = np.asarray(values).ravel()
            if vals.size != batch.size:
                raise ValueError(
                    f"values length {vals.size} != keys length {batch.size}")
        done = 0
        with self._write_lock:
            while done < batch.size:
                memtable = self._writable_memtable()
                take = min(memtable.room, batch.size - done)
                memtable.insert_many(
                    batch[done:done + take],
                    None if vals is None else vals[done:done + take])
                done += take
        return done

    def delete(self, key: float) -> None:
        """Delete every live occurrence of ``key`` across all levels
        (memtable occurrences eagerly, run occurrences via tombstone)."""
        with self._write_lock:
            self._writable_memtable().delete(key)

    def upsert(self, key: float, value=None) -> None:
        """Atomic delete+insert: one live occurrence remains, newest value
        wins across every level."""
        if value is not None and not self.has_payload:
            raise ValueError("service built without payload; upsert(key) only")
        with self._write_lock:
            self._writable_memtable().upsert(key, value)

    # -- spill -------------------------------------------------------------
    def spill(self) -> int:
        """Force the memtable into a fresh L0 run (test/bench control knob;
        the write path spills automatically on full).  Returns the number of
        keys spilled."""
        with self._write_lock:
            level_set = self._level_set
            if level_set.memtable.is_empty():
                return 0
            spilled = level_set.memtable.size
            self._spill_locked(level_set)
            return spilled

    def _spill_locked(self, level_set: LevelSet) -> LevelSet:
        """Freeze the memtable into a new L0 run and publish the successor
        manifest.  Caller holds ``_write_lock`` and passes its pinned
        manifest; the old memtable is abandoned (pinned readers keep it),
        never mutated."""
        t0 = time.perf_counter_ns()
        view = level_set.memtable.view()
        run = self._make_run(view.keys, view.payload, level=0,
                             tombstones=view.tombstones)
        runs = _with_shadows((run,) + level_set.runs)
        self._level_set = successor = LevelSet(
            version=level_set.version + 1,
            memtable=self._fresh_memtable(), runs=runs)
        self._spills += 1
        monitor = self.monitor
        if monitor is not None:
            monitor.record(CH_SPILL, float(view.n_keys),
                           float(time.perf_counter_ns() - t0))
        return successor

    # -- compaction --------------------------------------------------------
    def compact(self, max_steps: int = 1) -> int:
        """Run up to ``max_steps`` compaction passes now (foreground);
        returns total runs merged."""
        merged = 0
        for _ in range(max_steps):
            step = self.compactor.step()
            if step == 0:
                break
            merged += step
        return merged

    def _build_merged_run(self, group: Sequence[Run],
                          drop_tombstones: bool) -> Run:
        """Merge a newest-first run group into one run a level deeper.

        Within the group a newer member's tombstones permanently delete older
        members' occurrences; occurrences shadowed by runs *outside* (newer
        than) the group are kept -- those tombstones stay live and reshadow
        the merged run at swap.  Runs on the compactor thread holding only
        ``Compactor._lock``; touches no service state besides ``_run_seq``
        (guarded by being the only compaction in flight).
        """
        t0 = time.perf_counter_ns()
        with span(self.monitor, "lsm.merge"):
            kill = _EMPTY_KEYS
            parts_k: list[np.ndarray] = []
            parts_p: list[np.ndarray] = []
            tombs: set[float] = set()
            for run in group:
                run_keys = run.snapshot.table.keys
                if kill.size and run_keys.size:
                    live = ~np.isin(run_keys, kill)
                    parts_k.append(run_keys[live])
                    if self.has_payload:
                        parts_p.append(run.snapshot.payload[live])
                else:
                    parts_k.append(run_keys)
                    if self.has_payload:
                        parts_p.append(run.snapshot.payload)
                tombs.update(run.tombstones.tolist())
                kill = _sorted_unique(tombs)
            # stable merge keeps newest-first order among equal keys,
            # preserving the fan-in's duplicate payload ordering after it
            merged_keys, merged_payload = merge_sorted_sources(
                parts_k, parts_p if self.has_payload else None)
        run = self._make_run(
            merged_keys, merged_payload, level=group[0].level + 1,
            tombstones=_EMPTY_KEYS if drop_tombstones else _sorted_unique(
                tombs))
        monitor = self.monitor
        if monitor is not None:
            monitor.record(CH_COMPACT, float(len(group)),
                           float(merged_keys.size),
                           float(time.perf_counter_ns() - t0))
        return run

    def _swap_merged(self, group: Sequence[Run], merged: Run) -> None:
        """Publish the post-compaction manifest: replace the group with the
        merged run in place, reconciling runs spilled since the group was
        picked (spills only prepend, so group members are matched by
        run_id)."""
        group_ids = {r.run_id for r in group}
        with self._write_lock:
            level_set = self._level_set
            runs: list[Run] = []
            placed = False
            for run in level_set.runs:
                if run.run_id in group_ids:
                    if not placed:
                        runs.append(merged)
                        placed = True
                else:
                    runs.append(run)
            if not placed:  # group vanished? impossible, but stay safe
                runs.append(merged)
            self._level_set = LevelSet(version=level_set.version + 1,
                                       memtable=level_set.memtable,
                                       runs=_with_shadows(runs))

    # -- maintenance (pipeline duck-type) ----------------------------------
    def publish(self) -> dict:
        """One maintenance tick: spill if the memtable is full (writes
        normally spill inline; this catches tombstone-only fills and idle
        flushes) and run one compaction step.  Returns ``{}`` when there was
        nothing to do -- the async pipeline counts truthy results as publish
        activity."""
        out: dict[str, int] = {}
        spilled = self._maybe_spill()
        if spilled:
            out["spilled"] = spilled
        merged = self.compact()
        if merged:
            out["compacted"] = merged
        return out

    def _maybe_spill(self) -> int:
        with self._write_lock:
            level_set = self._level_set
            memtable = level_set.memtable
            if not memtable.is_full():
                return 0
            spilled = memtable.size
            self._spill_locked(level_set)
            return spilled

    # -- read path ---------------------------------------------------------
    def _pin_view(self, backend: str | None = None) -> _LsmView:
        """Pin one consistent manifest and prebuild per-run corrections for
        the verb math (engines, newer-run shadows are already on the runs;
        live memtable tombstones are folded in here, deduplicated against
        each run's shadow_keys so nothing is subtracted twice)."""
        chosen = backend or self.default_backend
        level_set = self._pin_level_set()
        mem = level_set.memtable.view()
        engines = tuple(r.handle.engine(chosen) for r in level_set.runs)
        extras = []
        total = mem.n_keys
        for run in level_set.runs:
            if mem.tombstones.size:
                extra_keys = np.setdiff1d(mem.tombstones, run.shadow_keys,
                                          assume_unique=True)
                extra_cum = _occurrence_cum(run.snapshot.table.keys,
                                            extra_keys)
            else:
                extra_keys, extra_cum = _EMPTY_KEYS, _ZERO_CUM
            extras.append((extra_keys, extra_cum))
            total += run.live_keys - int(extra_cum[-1])
        monitor = self.monitor
        if monitor is not None and next(self._amp_counter) \
                % _AMP_SAMPLE_EVERY == 0:
            monitor.record(CH_READ_AMP, float(1 + len(engines)))
        return _LsmView(level_set=level_set, mem=mem, engines=engines,
                        extras=tuple(extras), total=total)

    def _search_view(self, view: _LsmView, queries, side: str) -> np.ndarray:
        """Global live ranks: leftmost-rank fan-in over memtable + runs with
        shadowed occurrences subtracted (same merge the cross-shard stitcher
        performs over contiguous shards, generalized to overlapping
        sources)."""
        with span(self.monitor, "lsm.read"):
            flat = np.asarray(queries, dtype=np.float64).ravel()
            ranks = np.searchsorted(view.mem.keys, flat,
                                    side=side).astype(np.int64)
            for run, engine, (extra_keys, extra_cum) in zip(
                    view.level_set.runs, view.engines, view.extras):
                local = np.asarray(engine.search(flat, side),
                                   dtype=np.int64).ravel()
                if run.shadow_keys.size:
                    local = local - run.shadow_cum[
                        np.searchsorted(run.shadow_keys, flat, side=side)]
                if extra_keys.size:
                    local = local - extra_cum[
                        np.searchsorted(extra_keys, flat, side=side)]
                ranks += local
        return ranks

    def _count(self, verb: str, n: int = 1) -> None:
        with self._counts_lock:
            self._query_counts[verb] += n

    # -- verbs -------------------------------------------------------------
    def search(self, queries, side: str = "left",
               backend: str | None = None) -> np.ndarray:
        """Global live rank(s) of ``queries`` across every level."""
        check_side(side)
        with sanitizer.pin_scope("search"):
            view = self._pin_view(backend)
            arr = np.asarray(queries, dtype=np.float64)
            ranks = self._search_view(view, arr, side)
        self._count("searches", max(int(arr.size), 1))
        return ranks.reshape(arr.shape) if arr.shape != ranks.shape else ranks

    def lookup(self, queries, backend: str | None = None) -> np.ndarray:
        """Leftmost live ranks (vector alias the pipeline fuses on)."""
        return self.search(queries, "left", backend)

    def point(self, query: float, backend: str | None = None) -> PointResult:
        """Membership + leftmost live rank.  With duplicates and tombstones
        in play, existence is the rank gap right-left at the query key."""
        with sanitizer.pin_scope("point"):
            view = self._pin_view(backend)
            q = np.asarray([query], dtype=np.float64)
            lo = int(self._search_view(view, q, "left")[0])
            hi = int(self._search_view(view, q, "right")[0])
        self._count("points")
        return PointResult(rank=lo if hi > lo else -1, found=hi > lo)

    def count(self, lo: float, hi: float,
              backend: str | None = None) -> int:
        """Live occurrences in the inclusive key range [lo, hi]."""
        with sanitizer.pin_scope("count"):
            view = self._pin_view(backend)
            bounds = np.asarray([lo, hi], dtype=np.float64)
            lo_rank = int(self._search_view(view, bounds[:1], "left")[0])
            hi_rank = int(self._search_view(view, bounds[1:], "right")[0])
        self._count("counts")
        return max(hi_rank - lo_rank, 0)

    def range(self, lo: float, hi: float,
              backend: str | None = None) -> RangeResult:
        """Materialized inclusive range scan: live keys (sorted) and, when
        the service carries payload, values ordered newest-source-first among
        duplicate keys."""
        check_range(lo, hi)
        with sanitizer.pin_scope("range"):
            view = self._pin_view(backend)
            bounds = np.asarray([lo, hi], dtype=np.float64)
            lo_rank = int(self._search_view(view, bounds[:1], "left")[0])
            hi_rank = max(int(self._search_view(view, bounds[1:],
                                                "right")[0]), lo_rank)
            keys_out, payload_out = self._materialize_range(view, lo, hi)
        self._count("ranges")
        return RangeResult(lo=lo, hi=hi, lo_rank=lo_rank, hi_rank=hi_rank,
                           keys=keys_out, payload=payload_out)

    def _materialize_range(self, view: _LsmView, lo: float, hi: float):
        """Collect live in-range slices source by source (memtable first,
        then newest->oldest runs), drop shadowed occurrences, and stable-merge
        so duplicates surface newest-first."""
        bounds = np.asarray([lo, hi], dtype=np.float64)
        parts_k: list[np.ndarray] = []
        parts_p: list[np.ndarray] = []
        a = int(np.searchsorted(view.mem.keys, bounds[0], side="left"))
        b = int(np.searchsorted(view.mem.keys, bounds[1], side="right"))
        parts_k.append(view.mem.keys[a:b])
        if self.has_payload:
            parts_p.append(view.mem.payload[a:b])
        for run, engine, (extra_keys, _) in zip(
                view.level_set.runs, view.engines, view.extras):
            a = int(np.asarray(engine.search(bounds[:1], "left")).ravel()[0])
            b = int(np.asarray(engine.search(bounds[1:], "right")).ravel()[0])
            b = max(b, a)
            run_slice = run.snapshot.table.keys[a:b]
            if run_slice.size == 0:
                continue
            live = np.ones(run_slice.size, dtype=bool)
            if run.shadow_keys.size:
                live &= ~np.isin(run_slice, run.shadow_keys)
            if extra_keys.size:
                live &= ~np.isin(run_slice, extra_keys)
            parts_k.append(run_slice[live])
            if self.has_payload:
                parts_p.append(run.snapshot.payload[a:b][live])
        return merge_sorted_sources(parts_k,
                                    parts_p if self.has_payload else None)

    def predecessor(self, query: float,
                    backend: str | None = None) -> PointResult:
        """Largest live key <= query, as its global rank."""
        with sanitizer.pin_scope("predecessor"):
            view = self._pin_view(backend)
            q = np.asarray([query], dtype=np.float64)
            rank = int(self._search_view(view, q, "right")[0]) - 1
        self._count("predecessors")
        return PointResult(rank=rank, found=rank >= 0)

    def successor(self, query: float,
                  backend: str | None = None) -> PointResult:
        """Smallest live key >= query, as its global rank."""
        with sanitizer.pin_scope("successor"):
            view = self._pin_view(backend)
            q = np.asarray([query], dtype=np.float64)
            rank = int(self._search_view(view, q, "left")[0])
            total = view.total
        self._count("successors")
        return PointResult(rank=rank, found=rank < total)

    # -- observability -----------------------------------------------------
    def n_live_keys(self, backend: str | None = None) -> int:
        """Live occurrences across every level (oracle comparisons)."""
        with sanitizer.pin_scope("count"):
            return self._pin_view(backend).total

    def metrics(self) -> ServiceMetrics:
        """The typed observability tree, with the LSM node attached."""
        level_set = self._pin_level_set()
        memtable = level_set.memtable
        runs_per_level = level_set.runs_per_level()
        mem = memtable.view()
        live = mem.n_keys
        for run in level_set.runs:
            live += run.live_keys
            if mem.tombstones.size:
                # run occurrences the live memtable tombstones still shadow
                # (dedup against the run's own shadow set, as the fan-in does)
                extra = np.setdiff1d(mem.tombstones, run.shadow_keys,
                                     assume_unique=True)
                if extra.size:
                    live -= int(_occurrence_cum(run.snapshot.table.keys,
                                                extra)[-1])
        monitor = self.monitor
        read_amp = float(1 + level_set.n_runs)
        if monitor is not None:
            amp = monitor.channel(CH_READ_AMP)
            if amp.size:
                read_amp = float(np.mean(amp[:, 0]))
        with self._counts_lock:
            query_counts = dict(self._query_counts)
        lsm = LsmMetrics(
            level_set_version=level_set.version,
            memtable_keys=memtable.size,
            memtable_tombstones=memtable.tombstone_count,
            memtable_capacity=memtable.capacity,
            n_runs=level_set.n_runs,
            n_levels=len(runs_per_level),
            run_counts=runs_per_level,
            run_keys=level_set.keys_per_level(),
            live_keys=int(live),
            spills=self._spills,
            compactions=self.compactor.compactions,
            read_amplification=read_amp)
        return ServiceMetrics(
            service="lsm",
            shard_set_version=level_set.version,
            plan_revision=self.plan.revision,
            n_shards=1,
            imbalance=0.0,
            rebalances=0,
            rebalance_skipped=0,
            last_rebalance=None,
            pending_inserts=memtable.size + memtable.tombstone_count,
            query_counts=query_counts,
            shards=(),
            tiers=tier_metrics(monitor) if monitor is not None else (),
            lsm=lsm)

    # -- pipeline compatibility surface ------------------------------------
    def prewarm(self, backend: str | None = None,
                batch_sizes: Sequence[int] | None = None) -> None:
        """Warm per-run engines (and their dispatch tiers) off the hot path."""
        chosen = backend or self.default_backend
        level_set = self._pin_level_set()
        for run in level_set.runs:
            engine = run.handle.engine(chosen)
            warm = getattr(engine, "prewarm", None)
            if warm is not None:
                warm(batch_sizes=batch_sizes)

    def apply_plan(self, plan: "IndexPlan", *, prewarm: bool = False,
                   reshard: bool = True) -> "IndexPlan":
        """Adopt a re-planned ``IndexPlan`` in place (replanner surface).
        Engine opts and sizing knobs apply to runs built from now on;
        existing immutable runs keep serving unchanged."""
        with self._write_lock:
            self.plan = plan
            if plan.memtable_capacity:
                self.memtable_capacity = int(plan.memtable_capacity)
            if plan.level_fanout:
                self.level_fanout = int(plan.level_fanout)
                self.compactor.fanout = max(2, int(plan.level_fanout))
            self._engine_opts = inject_monitor(
                plan.merge_engine_opts(None), self.monitor)
        if prewarm:
            self.prewarm()
        return plan

    def close(self) -> None:
        """Stop the background compactor (if running)."""
        self.compactor.stop()

    def __enter__(self) -> "LsmIndexService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
