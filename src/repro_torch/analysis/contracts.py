"""Serving-stack contract declarations for the torch port.

Port of the parts of ``repro.analysis.contracts`` that the port's serving
path uses: the ``hot_path`` marker and the global lock order the runtime
sanitizer's watchdog checks.  Pure stdlib, so host-only modules can import it
without pulling in torch.  The static checker (``python -m repro.analysis``)
reads the port's sources by the marker's and the locks' names, which match
the reference's.
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


# The global lock order, outermost first.  A thread holding lock i may only
# acquire locks j > i.  Names are ``ClassName.attr``, as passed to
# ``sanitizer.make_lock``, in the reference's relative order.
LOCK_ORDER = (
    "Compactor._lock",                   # one merge in flight (outermost:
                                         # the merge swaps manifests under
                                         # the LSM write lock)
    "ShardedIndexService._write_lock",   # writer serialisation
    "LsmIndexService._write_lock",       # LSM writer / manifest swap
    "AsyncIndexService._lock",           # pipeline queue state
    "Memtable._lock",                    # memtable mutate / view build
    "ServingHandle._lock",               # lazy per-snapshot engine build
    "DispatchEngine._lock",              # lazy tier-engine build
    "Monitor._make_lock",                # channel-ring creation
    "JSONLBackend._io_lock",             # telemetry sink flush
    "ShardedIndexService._counts_lock",  # verb counters
    "LsmIndexService._counts_lock",      # LSM verb counters (innermost)
)

LOCK_RANK = {name: i for i, name in enumerate(LOCK_ORDER)}
