"""Contracts and runtime sanitizer of the torch port (see ``repro.analysis``).

  contracts.py  -- the ``hot_path`` marker and the port's ``LOCK_ORDER``
  sanitizer.py  -- freeze-on-publish helpers, the sharded verbs' pin
                   tracking and the lock-order watchdog behind ``make_lock``
                   (``REPRO_SANITIZE=1``)

Both are pure stdlib.  The static checker is not ported: ``python -m
repro.analysis src/`` already reads the port's sources.
"""
from .contracts import LOCK_ORDER, LOCK_RANK, hot_path
from .sanitizer import (LockOrderError, PinViolation, enabled, freeze,
                        lock_graph_edges, make_lock, make_rlock, observe_pin,
                        pin_scope, published_array, set_enabled)

__all__ = ["LOCK_ORDER", "LOCK_RANK", "LockOrderError", "PinViolation",
           "enabled", "freeze", "hot_path", "lock_graph_edges", "make_lock",
           "make_rlock", "observe_pin", "pin_scope", "published_array",
           "set_enabled"]
