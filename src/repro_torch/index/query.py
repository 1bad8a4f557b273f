"""The typed query plane: point / range / count / predecessor / successor.

Port of ``repro.index.query`` (host numpy, copied): the verbs derive from
an engine's ``search`` exactly as in the reference, so the two packages
answer alike whenever their ``search`` ranks agree.

The paper's clustered page layout makes the index a *rank oracle over a
sorted key column* -- which answers far more than point membership: the
predecessor search that locates a rank also locates the start of a range
scan, and two of them bound any ``[lo, hi]`` span.  Until this module, that
machinery was stranded in legacy paths (``core/tree.range_query``,
``core/jax_index.range_count``) that bypassed the unified engine/snapshot/
sharded layers; now every verb derives from **one** backend primitive:

    search(queries, side)  ->  searchsorted(keys, queries, side) ranks

implemented per backend (numpy / torch-window / torch-bisect / cuda /
dispatch) as a bounded-window rank search -- the same interpolate-then-
bisect hot path as point lookups, generalized to both sides (see
``numpy_search`` / ``torch_search`` / ``kernel_search``).  The verbs here are
pure derivations, so all backends return identical answers by construction,
including duplicate runs and empty ranges:

    point(q)         rank of q's leftmost occurrence, found flag
    range(lo, hi)    global [lo_rank, hi_rank) span of the inclusive
                     [lo, hi] key range + optional materialized keys
    count(lo, hi)    hi_rank - lo_rank without materializing anything
    predecessor(q)   rank of the largest key <= q (rightmost occurrence)
    successor(q)     rank of the smallest key >= q (leftmost occurrence)

Boundary contract (the one all legacy paths now share): a range is
``[lo, hi]``-**inclusive**, resolved as the *leftmost* rank at ``lo``
(``side="left"``) and one past the *rightmost* rank at ``hi``
(``side="right"``), so duplicates of both endpoints are fully inside the
span; ``hi < lo`` and out-of-domain bounds degrade to empty spans, never
negative counts.

``QueryVerbs`` is mixed into every engine (``repro_torch.index.engine``);
``ServingHandle`` lifts the same verbs through snapshots.  This module is
numpy-only: no torch import, so the host path stays accelerator-free.
"""
from __future__ import annotations

import dataclasses

import numpy as np

SIDES = ("left", "right")


@dataclasses.dataclass(frozen=True)
class PointResult:
    """A batch of point-shaped answers (point / predecessor / successor).

    ``rank`` is the global rank of each answer key, -1 where ``found`` is
    False (absent key / no predecessor below the column / no successor
    above it).  For duplicated keys ``point`` and ``successor`` report the
    *leftmost* occurrence, ``predecessor`` the *rightmost* -- the occurrence
    nearest the query from its side."""
    rank: np.ndarray    # (Q,) i64, -1 where not found
    found: np.ndarray   # (Q,) bool

    @property
    def n_found(self) -> int:
        return int(self.found.sum())


@dataclasses.dataclass(frozen=True)
class RangeResult:
    """One inclusive ``[lo, hi]`` key-range scan over a snapshot.

    ``[lo_rank, hi_rank)`` is the global rank span (leftmost rank at ``lo``,
    one past the rightmost at ``hi``); ``count`` its length.  ``keys`` is
    the materialized sorted key run when the scan was issued with
    ``materialize=True`` (else None); ``payload`` the parallel payload run
    when the serving layer has a payload column (non-clustered index) --
    engines over a bare ``SegmentTable`` always return ``payload=None``."""
    lo: float
    hi: float
    lo_rank: int
    hi_rank: int
    keys: np.ndarray | None = None
    payload: np.ndarray | None = None

    @property
    def count(self) -> int:
        return self.hi_rank - self.lo_rank

    @property
    def empty(self) -> bool:
        return self.hi_rank <= self.lo_rank


def check_side(side: str) -> str:
    if side not in SIDES:
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    return side


def check_range(lo, hi) -> tuple[float, float]:
    lo, hi = float(lo), float(hi)
    if np.isnan(lo) or np.isnan(hi):
        raise ValueError(f"range bounds must not be NaN, got [{lo}, {hi}]")
    return lo, hi


def merge_sorted_sources(parts_keys, parts_payload=None):
    """Stable k-way merge of per-source sorted key slices (the multi-level
    fan-in materializer: memtable + LSM runs, or any overlapping sources).

    Each element of ``parts_keys`` is a sorted array; the merged key column
    is globally sorted and, among *equal* keys, source order is preserved --
    pass sources newest-first and duplicates surface newest-first, the
    newest-level-wins contract the tiered write plane materializes ranges
    under.  ``parts_payload`` (parallel slices) rides the same permutation;
    returns ``(keys, payload-or-None)``."""
    keys = (np.concatenate([np.asarray(p, np.float64) for p in parts_keys])
            if parts_keys else np.empty(0, np.float64))
    order = np.argsort(keys, kind="stable")
    merged = keys[order]
    if parts_payload is None:
        return merged, None
    return merged, np.concatenate(parts_payload)[order]


class QueryVerbs:
    """Derives every typed verb from ``self.search(queries, side)``.

    Mixed into the engines (which also provide ``self.table``); any object
    with those two attributes gets the full query plane for free, and all
    implementations agree because there is nothing backend-specific left to
    disagree about."""

    def point(self, queries) -> PointResult:
        """Membership + leftmost rank: the typed form of ``lookup``."""
        q = np.asarray(queries, np.float64)
        rank = self.search(q, "left")
        keys = self.table.keys
        n = keys.shape[0]
        found = (rank < n) & (n > 0)
        if n > 0:
            found &= keys[np.minimum(rank, n - 1)] == q
        return PointResult(rank=np.where(found, rank, -1), found=found)

    def count(self, lo, hi) -> np.ndarray:
        """Keys in the inclusive ``[lo, hi]`` ranges (vectorized; broadcast
        ``lo``/``hi``).  Inverted or out-of-domain ranges count 0."""
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        return np.maximum(self.search(hi, "right") - self.search(lo, "left"),
                          0).astype(np.int64)

    def range(self, lo, hi, *, materialize: bool = True) -> RangeResult:
        """Scan one inclusive ``[lo, hi]`` key range: global rank span plus
        (optionally) the materialized key run."""
        lo, hi = check_range(lo, hi)
        lo_rank = int(self.search(np.asarray([lo]), "left")[0])
        hi_rank = max(int(self.search(np.asarray([hi]), "right")[0]), lo_rank)
        keys = None
        if materialize:
            keys = self.table.keys[lo_rank:hi_rank].copy()
        return RangeResult(lo=lo, hi=hi, lo_rank=lo_rank, hi_rank=hi_rank,
                           keys=keys)

    def predecessor(self, queries) -> PointResult:
        """Rank of the largest key <= each query (rightmost occurrence),
        found=False where the whole column is above the query."""
        q = np.asarray(queries, np.float64)
        rank = self.search(q, "right") - 1
        found = rank >= 0
        return PointResult(rank=np.where(found, rank, -1), found=found)

    def successor(self, queries) -> PointResult:
        """Rank of the smallest key >= each query (leftmost occurrence),
        found=False where the whole column is below the query."""
        q = np.asarray(queries, np.float64)
        rank = self.search(q, "left")
        found = rank < self.table.n_keys
        return PointResult(rank=np.where(found, rank, -1), found=found)
