"""Epoch-snapshot publishing: the route from inserts to serving.

Port of ``repro.index.snapshot``.  Device serving runs over an *immutable*
``SegmentTable``; this module publishes one and swaps it into serving:

    snap = publisher.publish()         # flush dirty segments -> new table
    handle.install(snap)               # atomic swap; readers never block

or, without a mutable tree, ``Snapshot.from_arrays(keys, error)`` fits and
publishes in one step.

``ServingHandle`` is the serving-side anchor: ``install`` swaps the current
(snapshot, engine-cache) pair with a single reference assignment, so an
in-flight ``lookup`` that already pinned the old pair keeps a fully consistent
view (epoch semantics, no torn reads, no reader locks).  Every verb serves
through the ``cuda`` backend (the fused CUDA search kernel on the card)
unless the caller names another; per-backend engine options (``device``
among them) come from ``engine_opts``, so ``{"cuda": {"device": "cpu"}}``
runs the default backend on the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.sanitizer import make_lock, published_array

from .engine import LookupEngine, make_engine
from .query import PointResult, RangeResult
from .table import SegmentTable
from .telemetry import span


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One published epoch of the index.

    ``payload`` is the payload column parallel to ``table.keys`` for a
    non-clustered index (None for the clustered layout), so range scans can
    materialize values from the same immutable epoch they resolved ranks
    against."""
    table: SegmentTable
    epoch: int
    n_refit: int  # dirty segments re-segmented by this publish
    payload: np.ndarray | None = None

    @property
    def n_keys(self) -> int:
        return self.table.n_keys

    @classmethod
    def from_arrays(cls, keys, error: int, *, payload=None, epoch: int = 0,
                    mode: str = "paper",
                    assume_sorted: bool = False) -> "Snapshot":
        """Fit-and-publish in one step: a fresh epoch straight from raw
        arrays, bypassing the mutable tree (the LSM run-build path, bulk
        loads, tests).  Keys and payload are co-sorted unless
        ``assume_sorted``; both arrays freeze on publish."""
        arr = np.asarray(keys, np.float64).ravel()
        pay = None if payload is None else np.asarray(payload).ravel()
        if pay is not None and pay.size != arr.size:
            raise ValueError(f"payload length {pay.size} != key length "
                             f"{arr.size}")
        if arr.size and not assume_sorted:
            order = np.argsort(arr, kind="stable")
            arr = arr[order]
            if pay is not None:
                pay = pay[order]
        table = (SegmentTable.from_keys(arr, error, mode=mode,
                                        assume_sorted=True, epoch=epoch)
                 if arr.size else SegmentTable.empty(error, epoch=epoch))
        return cls(table=table, epoch=epoch, n_refit=table.n_segments,
                   payload=None if pay is None else published_array(pay))


class SnapshotPublisher:
    """Write-side: turns a mutable tree into a stream of snapshots.

    Duck-typed on the tree: it needs ``flush(device)`` (re-fit dirty
    segments on ``device``, return how many), ``as_table(epoch=)``,
    ``payload_column()`` and ``dirty_segments()``, as
    ``repro_torch.core.tree.FITingTree`` has them.  ``device`` is where the
    published tables serve (None: the host); the re-fit runs there.  With a
    ``monitor`` each publish's flush is the ``tree.flush`` span, tagged with
    the segments it re-fit and those of them fitted on a CUDA card."""

    def __init__(self, tree, monitor=None, device=None):
        self.tree = tree
        self.monitor = monitor
        self.device = torch.device("cpu" if device is None else device)
        self._epoch = 0

    @property
    def epoch(self) -> int:
        """Epoch of the last publish (0 = nothing published yet)."""
        return self._epoch

    def dirty_segments(self) -> list[int]:
        """Segments with buffered inserts not yet visible to serving."""
        return self.tree.dirty_segments()

    def publish(self) -> Snapshot:
        """Flush dirty segments and emit a fresh immutable snapshot.

        Cost is O(sum of dirty segment lengths) for the re-fit plus O(N + S)
        to assemble the flat arrays; clean segments are never re-segmented.
        """
        with span(self.monitor, "tree.flush") as sp:
            n_refit = self.tree.flush(self.device)
            sp.tag(n_refit, n_refit if self.device.type == "cuda" else 0)
        self._epoch += 1
        table = self.tree.as_table(epoch=self._epoch)
        # freeze-on-publish: the payload column escapes into serving threads
        # with the table (whose arrays freeze at construction) -- a latent
        # in-place write through either must raise, not corrupt the epoch
        return Snapshot(table=table, epoch=self._epoch, n_refit=n_refit,
                        payload=published_array(self.tree.payload_column()))


class ServingHandle:
    """Read-side: pin-and-lookup over the latest installed snapshot.

    Engines are built lazily per backend per snapshot and cached alongside the
    snapshot they serve, so a swap atomically retires both the table and its
    compiled lookup closures.  With a ``monitor`` each build is the
    ``engine.build`` span (the table's device form and its upload), tagged
    with the table's keys and segments.
    """

    def __init__(self, engine_opts: dict[str, dict] | None = None,
                 monitor=None):
        self._engine_opts = engine_opts or {}
        self.monitor = monitor
        self._lock = make_lock("ServingHandle._lock")
        self._state: tuple[Snapshot, dict[str, LookupEngine]] | None = None

    @property
    def epoch(self) -> int:
        state = self._state
        return 0 if state is None else state[0].epoch

    def current(self) -> Snapshot:
        state = self._state
        if state is None:
            raise RuntimeError("no snapshot installed yet")
        return state[0]

    def install(self, snapshot: Snapshot) -> None:
        """Atomic swap: one reference assignment publishes the new epoch."""
        self._state = (snapshot, {})

    def engine(self, backend: str = "cuda") -> LookupEngine:
        return self._engine_from(self._pin(), backend)

    def _engine_from(self, state: tuple[Snapshot, dict[str, LookupEngine]],
                     backend: str) -> LookupEngine:
        """Engine for an already-pinned (snapshot, cache) state, so a verb
        that also reads the snapshot (e.g. its payload column) resolves both
        against one consistent epoch even if ``install`` lands mid-call."""
        snapshot, engines = state
        eng = engines.get(backend)
        if eng is None:
            with self._lock:
                eng = engines.get(backend)
                if eng is None:
                    table = snapshot.table
                    with span(self.monitor, "engine.build", table.n_keys,
                              table.n_segments):
                        eng = make_engine(table, backend,
                                          **self._engine_opts.get(backend,
                                                                  {}))
                    engines[backend] = eng
        return eng

    def lookup(self, queries, backend: str = "cuda") -> np.ndarray:
        """Rank of each query in the current snapshot, -1 if absent."""
        return self.engine(backend).lookup(queries)

    # ------------------------------------------------------- typed query plane
    def search(self, queries, side: str = "left",
               backend: str = "cuda") -> np.ndarray:
        """Insertion ranks (``searchsorted`` semantics) in the current
        snapshot -- the primitive every verb below derives from."""
        return self.engine(backend).search(queries, side)

    def point(self, queries, backend: str = "cuda") -> PointResult:
        return self.engine(backend).point(queries)

    def count(self, lo, hi, backend: str = "cuda") -> np.ndarray:
        return self.engine(backend).count(lo, hi)

    def range(self, lo, hi, *, materialize: bool = True,
              backend: str = "cuda") -> RangeResult:
        """Inclusive ``[lo, hi]`` scan over the current snapshot; payloads
        (non-clustered index) materialize from the same pinned snapshot the
        ranks were resolved against."""
        state = self._pin()
        snapshot = state[0]
        res = self._engine_from(state, backend).range(lo, hi,
                                                      materialize=materialize)
        if materialize and snapshot.payload is not None:
            res = dataclasses.replace(
                res, payload=snapshot.payload[res.lo_rank:res.hi_rank].copy())
        return res

    def predecessor(self, queries, backend: str = "cuda") -> PointResult:
        return self.engine(backend).predecessor(queries)

    def successor(self, queries, backend: str = "cuda") -> PointResult:
        return self.engine(backend).successor(queries)

    def _pin(self) -> tuple[Snapshot, dict[str, LookupEngine]]:
        state = self._state
        if state is None:
            raise RuntimeError("no snapshot installed yet")
        return state
