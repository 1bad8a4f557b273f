"""Contracts and runtime sanitizer of the torch port (see ``repro.analysis``).

  contracts.py  -- the ``hot_path`` marker and the port's ``LOCK_ORDER``
  sanitizer.py  -- freeze-on-publish helpers and the lock-order watchdog
                   behind ``make_lock`` (``REPRO_SANITIZE=1``)

Both are pure stdlib.  The static checker is not ported: ``python -m
repro.analysis src/`` already reads the port's sources.
"""
from .contracts import LOCK_ORDER, LOCK_RANK, hot_path
from .sanitizer import (LockOrderError, enabled, freeze, lock_graph_edges,
                        make_lock, make_rlock, published_array, set_enabled)

__all__ = ["LOCK_ORDER", "LOCK_RANK", "LockOrderError", "enabled", "freeze",
           "hot_path", "lock_graph_edges", "make_lock", "make_rlock",
           "published_array", "set_enabled"]
