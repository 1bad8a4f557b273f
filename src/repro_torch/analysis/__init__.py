"""Static invariant checker and runtime sanitizer of the torch port (port of
``repro.analysis``).

  contracts.py  -- the machine-readable contract declarations (frozen
                   classes, pinned fields, the port's host-only modules and
                   accelerator import roots, the hot-path marker, the global
                   LOCK_ORDER) shared by both layers
  invariants.py -- AST static checker, rules RI001-RI007 with
                   ``# repro: allow[RULE]`` suppression
  cli.py        -- ``python -m repro_torch.analysis src/repro_torch
                   [--strict]``
  sanitizer.py  -- opt-in runtime layer (``REPRO_SANITIZE=1``):
                   freeze-on-publish helpers, the per-verb pin tracking and
                   the lock-order watchdog behind ``make_lock``

All are pure stdlib.  The reference checker (``python -m repro.analysis``)
cannot see the port's host-only modules (its RI004 names ``repro/...`` paths
and ``jax`` roots), so the port runs its own over ``src/repro_torch``.  The
checker's names resolve lazily (PEP 562); it is only imported by the CLI and
tests.
"""
from .contracts import LOCK_ORDER, LOCK_RANK, hot_path
from .sanitizer import (LockOrderError, PinViolation, enabled, freeze,
                        lock_graph_edges, make_lock, make_rlock, observe_pin,
                        pin_scope, published_array, set_enabled)

_INVARIANT_NAMES = {"Analyzer", "RULES", "Violation", "check_source"}

__all__ = ["LOCK_ORDER", "LOCK_RANK", "LockOrderError", "PinViolation",
           "enabled", "freeze", "hot_path", "lock_graph_edges", "make_lock",
           "make_rlock", "observe_pin", "pin_scope", "published_array",
           "set_enabled", *sorted(_INVARIANT_NAMES)]


def __getattr__(name):
    if name in _INVARIANT_NAMES:
        from . import invariants
        return getattr(invariants, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
