"""Opt-in runtime sanitizer for the port's serving path (``REPRO_SANITIZE=1``).

Port of the parts of ``repro.analysis.sanitizer`` that the serving path
calls, with the same behaviour under the same environment variable:

* **Freeze-on-publish** -- :func:`freeze` / :func:`published_array` set
  ``writeable=False`` on every array that escapes into a ``Snapshot`` /
  ``SegmentTable``, so a latent in-place write raises at the write site.
  Freezing is unconditional; the flag controls the two checks below.
* **Pin tracking** -- every sharded query verb runs in a :func:`pin_scope`
  and reports the ``ShardSet`` version it pinned through
  :func:`observe_pin`; a verb that observed two versions raises
  :class:`PinViolation` at scope exit.
* **Lock-order watchdog** -- :func:`make_lock` / :func:`make_rlock` return
  plain ``threading`` locks when the sanitizer is off, and order-checking
  wrappers when on.  The wrappers keep a per-thread stack of held locks and
  raise :class:`LockOrderError` when an acquisition contradicts
  ``contracts.LOCK_ORDER`` or closes a cycle in the observed runtime graph.
"""
from __future__ import annotations

import os
import threading

from . import contracts

__all__ = [
    "enabled", "set_enabled", "freeze", "published_array",
    "pin_scope", "observe_pin", "PinViolation",
    "make_lock", "make_rlock", "LockOrderError", "lock_graph_edges",
]


def _env_enabled() -> bool:
    return os.environ.get("REPRO_SANITIZE", "") not in ("", "0", "false",
                                                        "False", "no")


class _State:
    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = _env_enabled()


_STATE = _State()


def enabled() -> bool:
    return _STATE.enabled


def set_enabled(on: bool) -> bool:
    """Flip the sanitizer (tests); returns the previous value."""
    prev = _STATE.enabled
    _STATE.enabled = bool(on)
    return prev


# ---------------------------------------------------------------------------
# freeze-on-publish
# ---------------------------------------------------------------------------
def freeze(arr):
    """Mark ``arr`` immutable in place; returns ``arr`` (None passes through).

    Views that do not own their data are copied first: freezing a view only
    protects the view, while the caller's base buffer would stay writeable --
    the copy both closes that hole and un-aliases caller scratch buffers.
    """
    if arr is None or not hasattr(arr, "flags"):
        return arr
    if arr.flags.writeable:
        if not arr.flags.owndata and arr.base is not None \
                and getattr(arr.base, "flags", None) is not None \
                and arr.base.flags.writeable:
            arr = arr.copy()
        arr.flags.writeable = False
    return arr


def published_array(arr):
    """Alias of :func:`freeze` for publish-path call sites (reads as intent)."""
    return freeze(arr)


# ---------------------------------------------------------------------------
# PinTracker
# ---------------------------------------------------------------------------
class PinViolation(AssertionError):
    """A query verb observed two distinct ShardSet versions end-to-end."""


class _PinTracker(threading.local):
    def __init__(self) -> None:
        self.scopes: list[tuple[str, set]] = []


_PINS = _PinTracker()


class _PinScope:
    __slots__ = ("verb",)

    def __init__(self, verb: str) -> None:
        self.verb = verb

    def __enter__(self) -> "_PinScope":
        _PINS.scopes.append((self.verb, set()))
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        verb, versions = _PINS.scopes.pop()
        if exc_type is None and len(versions) > 1:
            raise PinViolation(
                f"query verb {verb!r} touched {len(versions)} ShardSet "
                f"versions {sorted(versions)}; pin the shard set once per "
                f"operation (bind a local, then use the local)")
        return False


class _NullScope:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SCOPE = _NullScope()


def pin_scope(verb: str):
    """Context for one sharded query verb; no-op unless sanitizing."""
    if not _STATE.enabled:
        return _NULL_SCOPE
    return _PinScope(verb)


def observe_pin(version) -> None:
    """Record a ShardSet version seen by the innermost open verb scope."""
    if _STATE.enabled and _PINS.scopes:
        _PINS.scopes[-1][1].add(version)


# ---------------------------------------------------------------------------
# lock-order watchdog
# ---------------------------------------------------------------------------
class LockOrderError(RuntimeError):
    """Runtime lock acquisition contradicted the declared/observed order."""


class _Held(threading.local):
    def __init__(self) -> None:
        self.stack: list[str] = []


_HELD = _Held()
_GRAPH_LOCK = threading.Lock()
_GRAPH: dict[str, set] = {}  # observed runtime edges: held -> {acquired}


def lock_graph_edges() -> list[tuple[str, str]]:
    """Snapshot of the observed runtime acquisition edges (for tests/debug)."""
    with _GRAPH_LOCK:
        return sorted((a, b) for a, bs in _GRAPH.items() for b in bs)


def _reaches(graph: dict[str, set], src: str, dst: str) -> bool:
    seen, todo = set(), [src]
    while todo:
        n = todo.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        todo.extend(graph.get(n, ()))
    return False


def _check_order(name: str) -> None:
    """Validate acquiring ``name`` given this thread's held stack."""
    rank = contracts.LOCK_RANK.get(name)
    for held in _HELD.stack:
        if held == name:
            continue
        held_rank = contracts.LOCK_RANK.get(held)
        if (rank is not None and held_rank is not None
                and held_rank > rank):
            raise LockOrderError(
                f"acquiring {name} while holding {held} contradicts the "
                f"declared order in repro_torch.analysis.contracts.LOCK_ORDER")
        with _GRAPH_LOCK:
            # adding held -> name: a pre-existing name ->* held path = cycle
            if _reaches(_GRAPH, name, held):
                raise LockOrderError(
                    f"lock-order cycle: acquiring {name} while holding "
                    f"{held}, but {name} -> ... -> {held} was already "
                    f"observed at runtime")
            _GRAPH.setdefault(held, set()).add(name)


class _SanitizedLock:
    """Order-checking wrapper compatible with ``with``/``Condition`` use."""

    __slots__ = ("_name", "_lock", "_reentrant")

    def __init__(self, name: str, reentrant: bool) -> None:
        self._name = name
        self._reentrant = reentrant
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not (self._reentrant and self._name in _HELD.stack):
            _check_order(self._name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            _HELD.stack.append(self._name)
        return got

    def release(self) -> None:
        self._lock.release()
        # remove the innermost occurrence (re-entrant locks stack names)
        for i in range(len(_HELD.stack) - 1, -1, -1):
            if _HELD.stack[i] == self._name:
                del _HELD.stack[i]
                break

    def locked(self) -> bool:
        inner = getattr(self._lock, "locked", None)
        return inner() if inner is not None else False

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<SanitizedLock {self._name}>"


def make_lock(name: str):
    """A ``threading.Lock`` (plain when off, order-checked when sanitizing).

    ``name`` must be the canonical ``ClassName.attr`` identity used by
    ``contracts.LOCK_ORDER``.
    """
    if not _STATE.enabled:
        return threading.Lock()
    return _SanitizedLock(name, reentrant=False)


def make_rlock(name: str):
    """Re-entrant variant of :func:`make_lock`."""
    if not _STATE.enabled:
        return threading.RLock()
    return _SanitizedLock(name, reentrant=True)
