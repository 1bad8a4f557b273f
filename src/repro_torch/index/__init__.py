"""Index core of the torch port: one segment table, one router, one engine
per backend, and snapshot serving (counterpart of ``repro.index``).

Module map:
  table.py    -- immutable ``SegmentTable`` + ``route_keys`` (THE router) +
                 the shard partition helpers; numpy-only
  query.py    -- the typed query plane: ``PointResult``/``RangeResult`` and
                 the ``QueryVerbs`` mixin deriving point / range / count /
                 predecessor / successor from the one ``search`` primitive
  device.py   -- ``DeviceIndex`` (the table's f32/i32 device form),
                 ``predict_positions`` and the duplicate snaps: the
                 per-query math the engine and the kernels' twins share
  engine.py   -- ``LookupEngine`` registry: numpy / torch-window /
                 torch-bisect / cuda bounded-window search, the
                 ``DeviceIndex`` device form, and ``DispatchEngine``
  snapshot.py -- ``Snapshot`` + ``ServingHandle`` atomic swap into serving
  sharded.py  -- ``ShardedIndexService``: N key-partitioned writers with
                 per-shard epoch streams, read through one ``ViewTable``
                 (the pinned shards end to end); ``pack_shard_tables``
  fit.py      -- ``FitSpec`` -> ``plan()`` -> ``IndexPlan`` -> ``open_index``:
                 the Sec. 6 cost model resolving SLOs into every knob above
  lsm.py      -- ``LsmIndexService``: memtable -> learned runs -> size-tiered
                 ``Compactor``, one atomic ``LevelSet`` manifest, fan-in reads
  pipeline.py -- ``AsyncIndexService`` / ``open_pipeline``: the coalescing
                 front door and the publish / compaction cadence
  device_plane.py - ``DeviceShardedService``: the device-sharded serving
                 plane (replicated boundary router, one shard row per torch
                 device, allgather / bucketed all_to_all exchange, delta
                 epoch publish through the versioned ``DeviceShardSet``);
                 the reference's ``index/device.py``
  telemetry.py - ``Monitor``, the typed ``ServiceMetrics`` tree, and
                 ``Replanner`` (measure -> re-fit -> re-plan, hot-swapped)

``table`` and ``query`` are imported eagerly (pure numpy); the other names
resolve lazily (PEP 562) so host-only code never pulls in torch.
"""
from .query import (PointResult, QueryVerbs, RangeResult, check_range,
                    check_side, merge_sorted_sources)
from .table import (SegmentTable, build_shard_tables, numpy_lookup,
                    numpy_search, route_keys, shard_boundaries,
                    shard_cut_indices, shard_partition)

_ENGINE_NAMES = {
    "DeviceIndex", "DispatchEngine", "LookupEngine", "LookupPlan",
    "available_backends", "device_index", "kernel_lookup", "kernel_search",
    "make_engine", "make_plan", "predict_positions", "register_backend",
    "resolve_device", "snap_leftmost", "snap_side", "torch_lookup",
    "torch_search",
}
_SNAPSHOT_NAMES = {"ServingHandle", "Snapshot", "SnapshotPublisher"}
_SHARDED_NAMES = {"PackedShardTables", "ShardSet", "ShardStats",
                  "ShardedIndexService", "pack_shard_tables"}
_FIT_NAMES = {"FitSpec", "IndexPlan", "InfeasibleSpecError", "PlanCandidate",
              "open_index", "plan"}
_LSM_NAMES = {"Compactor", "LevelSet", "LsmIndexService", "MemView",
              "Memtable", "MemtableFullError", "Run"}
_DEVICE_NAMES = {"DeviceShardSet", "DeviceShardedService",
                 "sharded_lookup_a2a", "sharded_lookup_allgather",
                 "sharded_search_a2a", "sharded_search_allgather"}
_PIPELINE_NAMES = {"AsyncIndexService", "PipelineClosed",
                   "PipelineOverloaded", "open_pipeline"}
_TELEMETRY_NAMES = {"DeviceMetrics", "JSONLBackend", "LsmMetrics",
                    "MemoryBackend", "MetricsSnapshot", "Monitor",
                    "PipelineMetrics", "Replanner", "ServiceMetrics",
                    "ShardMetrics", "TierMetrics", "tier_metrics"}

__all__ = [
    "PointResult", "QueryVerbs", "RangeResult", "SegmentTable",
    "build_shard_tables", "check_range", "check_side",
    "merge_sorted_sources", "numpy_lookup", "numpy_search", "route_keys",
    "shard_boundaries", "shard_cut_indices", "shard_partition",
    *sorted(_ENGINE_NAMES), *sorted(_SNAPSHOT_NAMES), *sorted(_SHARDED_NAMES),
    *sorted(_FIT_NAMES), *sorted(_LSM_NAMES), *sorted(_DEVICE_NAMES),
    *sorted(_PIPELINE_NAMES), *sorted(_TELEMETRY_NAMES),
]


def __getattr__(name):
    if name in _ENGINE_NAMES:
        from . import engine
        return getattr(engine, name)
    if name in _SNAPSHOT_NAMES:
        from . import snapshot
        return getattr(snapshot, name)
    if name in _SHARDED_NAMES:
        from . import sharded
        return getattr(sharded, name)
    if name in _FIT_NAMES:
        from . import fit
        return getattr(fit, name)
    if name in _LSM_NAMES:
        from . import lsm
        return getattr(lsm, name)
    if name in _DEVICE_NAMES:
        from . import device_plane
        return getattr(device_plane, name)
    if name in _PIPELINE_NAMES:
        from . import pipeline
        return getattr(pipeline, name)
    if name in _TELEMETRY_NAMES:
        from . import telemetry
        return getattr(telemetry, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
