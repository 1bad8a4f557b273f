"""Index serving: epoch-snapshot front end over the unified index core.

Composes the write path (mutable ``FITingTree``, Alg. 4 buffered inserts) with
the read path (immutable ``SegmentTable`` snapshots served by any
``repro_torch.index.engine`` backend): writers mutate, ``publish`` cuts an
epoch, and the serving handle swaps the snapshot atomically so in-flight
lookups keep a consistent view.

    svc = IndexService(keys, error=64, buffer_size=16)   # on the CUDA card
    svc.lookup(q)            # epoch 1 (built at construction)
    svc.insert(k); ...       # buffered; serving unaffected
    svc.publish()            # epoch 2: inserts now visible to every backend

``IndexService`` is ``repro_torch.index.sharded.ShardedIndexService`` at one
shard, whose read path answers a one-shard view unrouted.  ``publish``
returns the shard's snapshot, and with nothing pending is a **no-op**
returning the current one, so cadence loops need no guard.

Port of ``repro.serve.index_service``.  It serves on the ``cuda`` backend,
the fused search kernel on the CUDA card, unless the caller names another
backend or passes ``engine_opts={"cuda": {"device": "cpu"}}``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.index.sharded import ShardedIndexService
from repro_torch.index.snapshot import Snapshot

if TYPE_CHECKING:  # runtime import is lazy (fit builds services via plans)
    from repro_torch.index.fit import IndexPlan


def _one_shard(plan: IndexPlan) -> IndexPlan:
    return plan if plan.n_shards == 1 else dataclasses.replace(plan,
                                                                n_shards=1)


class IndexService(ShardedIndexService):
    """One writable index + its serving handle, with optional auto-publish.

    Plan-first construction (see ``repro_torch.index.fit``): pass ``plan=`` to
    take error / buffer / backend / publish cadence / dispatch thresholds from
    a resolved ``IndexPlan`` (its shard count is replaced by 1, here and in
    :meth:`apply_plan`), or the raw expert knobs, which are wrapped in a
    trivially-resolved plan exposed as ``svc.plan``.  The rebalance-policy
    knobs are accepted (``fit.open_index`` passes them through) and inert.
    """

    def __init__(self, keys: np.ndarray, error: int | None = None, *,
                 plan: IndexPlan | None = None, buffer_size: int | None = None,
                 payload: np.ndarray | None = None, mode: str = "paper",
                 backend: str | None = None,
                 engine_opts: dict[str, dict] | None = None,
                 publish_every: int | None = None,
                 skew_threshold: float = 2.0, pending_weight: float = 1.0,
                 auto_rebalance: bool = False, assume_sorted: bool = False,
                 monitor=None):
        super().__init__(
            keys, error, plan=None if plan is None else _one_shard(plan),
            n_shards=1 if plan is None else None, buffer_size=buffer_size,
            payload=payload, mode=mode, backend=backend,
            engine_opts=engine_opts, publish_every=publish_every,
            skew_threshold=skew_threshold, pending_weight=pending_weight,
            auto_rebalance=auto_rebalance, assume_sorted=assume_sorted,
            monitor=monitor)

    def publish(self) -> Snapshot:
        """Cut a new epoch and swap it into serving atomically; with nothing
        pending, return the installed snapshot unchanged (same epoch)."""
        return super().publish().get(0, self.handle.current())

    def apply_plan(self, new_plan: IndexPlan, *,
                   reshard: bool = True) -> IndexPlan:
        """``ShardedIndexService.apply_plan`` with the shard count kept 1."""
        return super().apply_plan(_one_shard(new_plan), reshard=reshard)

    def metrics(self):
        """``ShardedIndexService.metrics`` under ``service="index"``."""
        return dataclasses.replace(super().metrics(), service="index")

    @property
    def tree(self):
        """The single shard's mutable FITingTree writer."""
        return self.writers[0]

    @property
    def publisher(self):
        return self.publishers[0]

    @property
    def handle(self):
        return self.handles[0]

    @property
    def epoch(self) -> int:
        return self.handle.epoch
