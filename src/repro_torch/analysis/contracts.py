"""Machine-readable serving-stack contracts of the torch port (the
*declarations* its tools read).

The single source of truth shared by the port's static checker
(``repro_torch.analysis.invariants``, ``python -m repro_torch.analysis``) and
its runtime sanitizer (``repro_torch.analysis.sanitizer``), as
``repro.analysis.contracts`` is for the JAX package.  Pure stdlib (no numpy,
no torch), so host-only modules can import ``hot_path`` without pulling in
anything heavy, and the checker runs on a bare interpreter.

The declarations are the reference's, with the port's names where they
differ: the host-only modules are ``repro_torch/...`` paths, and the import
roots that pull the accelerator stack in are ``torch``, ``triton`` and the
port's device-side modules.  The lock names match the reference's, so the
two lock orders agree on every lock both packages have.

Contracts declared here:

* ``FROZEN_CLASSES``      -- value types that are immutable after construction
                             (RI001: no attribute writes after construction).
* ``FROZEN_SETATTR_ALLOW``-- the setattr allowlist: (module suffix, function)
                             pairs that may use ``object.__setattr__`` on a
                             frozen instance (caches filled exactly once).
* ``PINNED_FIELDS`` / ``PINNED_SUFFIXES`` -- swap-on-publish handle fields
                             that read paths must dereference at most once per
                             method (RI002: pin a local, then use the local).
* ``FROZEN_ARRAY_FIELDS`` -- array attributes published inside snapshots /
                             tables; no in-place numpy mutation (RI003).
* ``HOST_ONLY_MODULES`` / ``ACCEL_IMPORT_ROOTS`` -- modules that must stay
                             importable without torch, and the import roots
                             that would (transitively) pull torch in (RI004).
* ``HOT_PATH_FORBIDDEN_CALLS`` -- call roots banned under ``@hot_path``
                             (RI005, alongside any lock acquisition).
* ``DEPRECATED_CALLS``    -- legacy dict-shaped stats surfaces kept only for
                             external callers (RI006: internal code uses the
                             typed ``metrics()`` tree).
* ``LOCK_ORDER``          -- the global partial order (outermost first) every
                             ``threading`` lock in the serving stack must be
                             acquired in (RI007 statically, the sanitizer's
                             watchdog at runtime).
"""
from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def hot_path(fn: F) -> F:
    """Mark ``fn`` as a serving hot path: no lock acquisition, no logging,
    no heap-allocating diagnostics (RI005).  Runtime no-op; the static
    checker keys off the decorator name and the sanitizer off the attribute."""
    fn.__hot_path__ = True
    return fn


# --------------------------------------------------------------------- RI001
# Value types whose instances are immutable once constructed.  Everything a
# reader thread can reach through a published snapshot must be in this set.
FROZEN_CLASSES = frozenset({
    "SegmentTable", "Snapshot", "ShardSet", "IndexPlan", "PlanCandidate",
    "PackedShardTables", "PointResult", "RangeResult", "ShardStats",
    "Segments",
    # typed metrics tree (read-only views handed to callers)
    "TierMetrics", "ShardMetrics", "PipelineMetrics", "ServiceMetrics",
    "MetricsSnapshot", "LsmMetrics",
    # LSM tiered write plane: the atomic level manifest and its parts
    "LevelSet", "Run", "MemView",
    # device serving plane: the device-resident manifest + its metrics node
    "DeviceShardSet", "DeviceMetrics",
})

# The setattr allowlist: (module path suffix, qualified function name) pairs
# that may call ``object.__setattr__`` on a frozen instance *outside* the
# class's own ``__init__``/``__post_init__`` (self-construction is always
# allowed).  Keep this list short and each entry a write-once cache.
FROZEN_SETATTR_ALLOW = frozenset({
    # one-shot device-form cache hung off the (host) SegmentTable
    ("repro_torch/index/engine.py", "device_index"),
})

# --------------------------------------------------------------------- RI002
# Swap-on-publish handle fields: read paths must bind the current value to a
# local exactly once ("pin"), then work off the local, or two reads may span
# a concurrent publish and observe a torn pair of versions.
PINNED_FIELDS = frozenset({"_shard_set", "_state", "_level_set",
                           "_device_set"})
PINNED_SUFFIXES = ("_handle", "_snapshot")

# --------------------------------------------------------------------- RI003
# Array attributes reachable from a published Snapshot / SegmentTable /
# ShardSet; in-place numpy mutation through any of these is a data race.
FROZEN_ARRAY_FIELDS = frozenset({
    "keys", "start_key", "slope", "base", "seg_end", "payload", "boundaries",
    "count", "tombstones", "shadow_keys", "shadow_cum", "offsets",
})
# ndarray methods that mutate in place.
INPLACE_NDARRAY_METHODS = frozenset({
    "fill", "sort", "partition", "put", "resize", "setfield", "itemset",
    "byteswap",
})

# --------------------------------------------------------------------- RI004
# Modules that the host-only tree path imports; they must never import torch
# (directly or through a torch-at-module-scope port module) at module scope.
HOST_ONLY_MODULES = (
    "repro_torch/index/table.py",
    "repro_torch/index/query.py",
    "repro_torch/index/telemetry.py",
    "repro_torch/core/tree.py",
    "repro_torch/core/segmentation.py",
    "repro_torch/core/cost_model.py",
    # the port's own: the sharding rules are host code (the reference's
    # import jax for their NamedSharding)
    "repro_torch/launch/sharding.py",
    # HLO-text parsing and the collective record (the accountant imports
    # torch when it traces), and the paged KV cache's bookkeeping
    "repro_torch/launch/hlo_analysis.py",
    "repro_torch/serve/paged_kv.py",
)
# Import roots that pull torch in at module scope (transitively included).
ACCEL_IMPORT_ROOTS = (
    "torch", "triton",
    "repro_torch.kernels", "repro_torch.models",
    "repro_torch.index.engine", "repro_torch.index.device",
    "repro_torch.index.snapshot", "repro_torch.index.sharded",
    "repro_torch.index.pipeline", "repro_torch.index.fit",
    "repro_torch.index.lsm", "repro_torch.index.device_plane",
    "repro_torch.core.torch_index", "repro_torch.core.distributed",
    "repro_torch.launch.mesh", "repro_torch.launch.train",
    "repro_torch.launch.specs", "repro_torch.launch.flops_count",
    "repro_torch.launch.dryrun", "repro_torch.serve.step",
    "repro_torch.serve.batcher", "repro_torch.serve.index_service",
    "repro_torch.train", "repro_torch.checkpoint",
)

# --------------------------------------------------------------------- RI005
# Call roots banned inside ``@hot_path`` functions (heap-allocating logging /
# diagnostics); lock acquisition is banned structurally, not by name.
HOT_PATH_FORBIDDEN_CALLS = frozenset({
    "print", "open", "logging", "warnings", "traceback",
})

# --------------------------------------------------------------------- RI006
# Deprecated dict-shaped surfaces; internal code must use ``metrics()``.
DEPRECATED_CALLS = frozenset({"stats", "service_stats", "pipeline_stats"})

# --------------------------------------------------------------------- RI007
# The global lock order, outermost first.  A thread holding lock i may only
# acquire locks j > i.  Names are ``ClassName.attr`` (matching both the
# static graph keys and the names passed to ``sanitizer.make_lock``), in the
# reference's relative order.
LOCK_ORDER = (
    "Compactor._lock",                   # one merge in flight (outermost:
                                         # the merge swaps manifests under
                                         # the LSM write lock)
    "DeviceShardedService._write_lock",  # device publish wraps host publish
    "ShardedIndexService._write_lock",   # writer serialisation
    "LsmIndexService._write_lock",       # LSM writer / manifest swap
    "AsyncIndexService._lock",           # pipeline queue state
    "Memtable._lock",                    # memtable mutate / view build
    "ServingHandle._lock",               # lazy per-snapshot engine build
    "DispatchEngine._lock",              # lazy tier-engine build
    "Monitor._make_lock",                # channel-ring creation
    "JSONLBackend._io_lock",             # telemetry sink flush
    "DeviceShardedService._counts_lock",  # device verb counters
    "ShardedIndexService._counts_lock",  # verb counters
    "LsmIndexService._counts_lock",      # LSM verb counters (innermost)
)

LOCK_RANK = {name: i for i, name in enumerate(LOCK_ORDER)}
