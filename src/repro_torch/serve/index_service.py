"""Index serving: epoch-snapshot front end over the unified index core.

Composes the write path (mutable ``FITingTree``, Alg. 4 buffered inserts) with
the read path (immutable ``SegmentTable`` snapshots served by any
``repro_torch.index.engine`` backend) the same way the LM serving stack threads
caches through steps: writers mutate, ``publish`` cuts an epoch, and the
serving handle swaps the snapshot atomically so in-flight lookups keep a
consistent view.

    svc = IndexService(keys, error=64, buffer_size=16)   # on the CUDA card
    svc.lookup(q)            # epoch 1 (built at construction)
    svc.insert(k); ...       # buffered; serving unaffected
    svc.publish()            # epoch 2: inserts now visible to every backend

``IndexService`` is the single-host form: a thin wrapper over a one-shard
``repro_torch.index.sharded.ShardedIndexService`` (the N-shard generalization
with per-shard epochs and adaptive shard rebalancing lives there; re-exported
by ``repro_torch.serve``).  ``publish`` with zero pending inserts is a
**no-op** returning the current snapshot -- periodic publish-cadence loops need no
guard logic and idle ticks don't churn epoch numbers or engine caches.
Rebalancing is inherently a no-op with one shard; use the sharded service
directly when write skew matters.

Port of ``repro.serve.index_service``.  It serves on the ``cuda`` backend,
the fused search kernel on the CUDA card, unless the caller names another
backend or passes ``engine_opts={"cuda": {"device": "cpu"}}``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.index.query import PointResult, RangeResult
from repro_torch.index.sharded import ShardedIndexService, ShardStats
from repro_torch.index.snapshot import Snapshot

if TYPE_CHECKING:  # runtime import is lazy (fit builds services via plans)
    from repro_torch.index.fit import IndexPlan


class IndexService:
    """One writable index + its serving handle, with optional auto-publish.

    Plan-first construction (see ``repro_torch.index.fit``): pass ``plan=`` to
    take error / buffer / backend / publish cadence / dispatch thresholds from a
    resolved ``IndexPlan`` (the shard count is forced to 1 -- this is the
    single-shard facade; ``fit.open_index`` picks the sharded service when
    the plan says so), or the raw expert knobs, which are wrapped in a
    trivially-resolved plan exposed as ``svc.plan``.
    """

    def __init__(self, keys: np.ndarray, error: int | None = None, *,
                 plan: IndexPlan | None = None, buffer_size: int | None = None,
                 payload: np.ndarray | None = None, mode: str = "paper",
                 backend: str | None = None,
                 engine_opts: dict[str, dict] | None = None,
                 publish_every: int | None = None,
                 skew_threshold: float = 2.0,
                 pending_weight: float = 1.0,
                 auto_rebalance: bool = False,
                 assume_sorted: bool = False,
                 monitor=None):
        n_shards = None
        if plan is None:
            n_shards = 1
        elif plan.n_shards != 1:
            plan = dataclasses.replace(plan, n_shards=1)
        # the rebalance-policy knobs are accepted (open_index passes them
        # through unconditionally) and inert: one shard never rebalances
        self._sharded = ShardedIndexService(
            keys, error, plan=plan, n_shards=n_shards,
            buffer_size=buffer_size, payload=payload, mode=mode,
            backend=backend, engine_opts=engine_opts,
            publish_every=publish_every, skew_threshold=skew_threshold,
            pending_weight=pending_weight, auto_rebalance=auto_rebalance,
            assume_sorted=assume_sorted, monitor=monitor)

    @classmethod
    def from_plan(cls, keys: np.ndarray, plan: IndexPlan, *,
                  payload: np.ndarray | None = None,
                  **service_kwargs) -> "IndexService":
        """Build from a resolved :class:`repro_torch.index.fit.IndexPlan` (the
        ``fit.open_index`` path for one-shard plans)."""
        return cls(keys, plan=plan, payload=payload, **service_kwargs)

    @property
    def plan(self) -> IndexPlan:
        """The plan this service was built from (trivially resolved when
        constructed from raw knobs)."""
        return self._sharded.plan

    # ----------------------------------------------------- one-shard plumbing
    @property
    def tree(self):
        """The single shard's mutable FITingTree writer."""
        return self._sharded.writers[0]

    @property
    def publisher(self):
        return self._sharded.publishers[0]

    @property
    def handle(self):
        return self._sharded.handles[0]

    @property
    def default_backend(self) -> str:
        return self._sharded.default_backend

    @property
    def publish_every(self) -> int | None:
        return self._sharded.publish_every

    # ------------------------------------------------------------- write path
    def insert(self, key: float, value=None) -> None:
        """Buffer an insert (Alg. 4).  Not visible to lookups until publish.
        Read-only / no-payload misuse is rejected by the underlying service."""
        self._sharded.insert(key, value)

    def insert_many(self, keys, values=None) -> None:
        """Buffer a batch of inserts in arrival order, routed at once (see
        ``ShardedIndexService.insert_many``)."""
        self._sharded.insert_many(keys, values)

    def publish(self) -> Snapshot:
        """Cut a new epoch and swap it into serving atomically.

        With zero pending inserts this is a no-op: the installed snapshot is
        returned unchanged (same epoch), so cadence loops can call it
        unconditionally."""
        published = self._sharded.publish()
        return published.get(0, self.handle.current())

    # -------------------------------------------------------------- read path
    def lookup(self, queries, backend: str | None = None) -> np.ndarray:
        """Rank of each query in the current epoch's key column, -1 if absent."""
        return self._sharded.lookup(queries, backend)

    # ------------------------------------------------------ typed query plane
    # (see repro_torch.index.query: every verb derives from the per-backend
    # bounded search primitive, so answers are backend-independent by construction)
    def search(self, queries, side: str = "left",
               backend: str | None = None) -> np.ndarray:
        """``searchsorted(keys, queries, side)`` insertion ranks in the
        current epoch's key column."""
        return self._sharded.search(queries, side, backend)

    def point(self, queries, backend: str | None = None) -> PointResult:
        """Typed membership: leftmost rank + found flag per query."""
        return self._sharded.point(queries, backend)

    def count(self, lo, hi, backend: str | None = None) -> np.ndarray:
        """Keys in the inclusive ``[lo, hi]`` ranges (vectorized)."""
        return self._sharded.count(lo, hi, backend)

    def range(self, lo, hi, *, materialize: bool = True,
              backend: str | None = None) -> RangeResult:
        """Inclusive ``[lo, hi]`` scan: global rank span + materialized keys
        (and payloads for a non-clustered index) from one pinned epoch."""
        return self._sharded.range(lo, hi, materialize=materialize,
                                   backend=backend)

    def predecessor(self, queries, backend: str | None = None) -> PointResult:
        """Rank of the largest key <= each query (rightmost occurrence)."""
        return self._sharded.predecessor(queries, backend)

    def successor(self, queries, backend: str | None = None) -> PointResult:
        """Rank of the smallest key >= each query (leftmost occurrence)."""
        return self._sharded.successor(queries, backend)

    def prewarm(self, backend: str | None = None,
                batch_sizes=None) -> None:
        """Build the serving engines (and dispatch tiers) now and run them
        once, so the first batch skips the lazy conversion and the kernel's
        first-use build."""
        self._sharded.prewarm(backend, batch_sizes=batch_sizes)

    @property
    def monitor(self):
        """The attached telemetry monitor (None when telemetry is off)."""
        return self._sharded.monitor

    def apply_plan(self, new_plan: "IndexPlan", *,
                   reshard: bool = True) -> "IndexPlan":
        """Hot-swap the served configuration (the ``Replanner`` path); the
        shard count stays 1 through this facade.  See
        ``ShardedIndexService.apply_plan``."""
        if new_plan.n_shards != 1:
            new_plan = dataclasses.replace(new_plan, n_shards=1)
        return self._sharded.apply_plan(new_plan, reshard=reshard)

    def metrics(self):
        """The typed observability snapshot (``MetricsSnapshot``); see
        ``ShardedIndexService.metrics``."""
        return dataclasses.replace(self._sharded.metrics(), service="index")

    def service_stats(self) -> dict:
        """Deprecated: use :meth:`metrics`.  Service-level observability
        incl. the per-shape query counters, derived field-for-field from the
        typed snapshot (RI006: no internal deprecated-surface calls)."""
        warnings.warn("IndexService.service_stats() is deprecated; use "
                      "metrics()", DeprecationWarning, stacklevel=2)
        m = self.metrics()
        return {"version": m.shard_set_version,
                "n_shards": m.n_shards,
                "imbalance": m.imbalance,
                "rebalances": m.rebalances,
                "rebalance_skipped": m.rebalance_skipped,
                "last_rebalance": m.last_rebalance,
                "pending_inserts": m.pending_inserts,
                "query_counts": m.query_counts}

    @property
    def epoch(self) -> int:
        return self.handle.epoch

    @property
    def pending_inserts(self) -> int:
        """Inserts buffered since the last publish (invisible to serving)."""
        return self._sharded.pending_inserts

    def stats(self):
        """Deprecated: use :meth:`metrics`\\ ``().shards``.  The single
        shard's observability sample in the legacy ``ShardStats`` shape."""
        warnings.warn("IndexService.stats() is deprecated; use "
                      "metrics().shards", DeprecationWarning, stacklevel=2)
        m = self.metrics()
        return [ShardStats(shard=s.shard, boundary=s.boundary, epoch=s.epoch,
                           n_segments=s.n_segments, n_keys=s.n_keys,
                           pending_inserts=s.pending_inserts,
                           snapshot_first_key=s.snapshot_first_key,
                           version=m.shard_set_version)
                for s in m.shards]
