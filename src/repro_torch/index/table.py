"""`SegmentTable`: the canonical, immutable form of the FITing-Tree index.

Every layer of the repo (host tree, XLA index, Pallas kernel plan, sharded
serving) used to build its own copy of the segment geometry; this module is now
the single source of truth.  A table is four parallel segment arrays plus the
sorted key column:

    position(k) ~ base[s] + (k - start_key[s]) * slope[s],   s = route(k)

with the paper's Eq. 1 guarantee |position(k) - true_rank(k)| <= error for
every key present in ``keys``.

The *router* -- rightmost segment whose start key is <= k -- is implemented
exactly once, in :func:`route_keys`; the host tree, the numpy engine and (in
f32 form) the device engines in ``repro_torch.index.engine`` all defer to this
module's semantics.

Port of ``repro.index.table`` (host numpy, copied).  It stays numpy-only (no
torch import) so host-side code can use it without touching an accelerator
runtime; device conversion lives in ``repro_torch.index.engine``.  The port
adds :meth:`SegmentTable.to_state` / :meth:`SegmentTable.from_state`, which
carry a table across packages as plain numpy arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.analysis.sanitizer import published_array

if TYPE_CHECKING:  # avoid a module-level cycle with repro_torch.core
    from repro_torch.core.segmentation import Mode, Segments


def route_keys(start_keys: np.ndarray, queries) -> np.ndarray:
    """THE router (Alg. 3 line 1): rightmost segment with start_key <= q.

    Queries below the first start key clamp to segment 0, above the last to
    the final segment.  All other route implementations in the repo must agree
    with this one (the device engines mirror it in f32).
    """
    sid = np.searchsorted(start_keys, queries, side="right") - 1
    return np.clip(sid, 0, start_keys.shape[0] - 1)


@dataclasses.dataclass(frozen=True)
class SegmentTable:
    """Immutable packed index: segment metadata + the sorted key column.

    ``error`` is the bound the segmentation satisfies over ``keys`` (for a
    tree with an insert buffer this is the *segmentation* budget err_seg, so
    the user-visible bound still holds; see tree.py Sec. 5 notes).  ``epoch``
    tags published snapshots (see repro_torch.index.snapshot); 0 means "built
    from scratch".  ``_device_cache`` holds the table's device forms, one per
    torch device (filled by ``repro_torch.index.engine.device_index``); it
    takes no part in equality.
    """

    start_key: np.ndarray  # (S,) f64  first key of each segment
    slope: np.ndarray      # (S,) f64  positions per key unit
    base: np.ndarray       # (S,) i64  global rank of the segment's first key
    seg_end: np.ndarray    # (S,) i64  one past the segment's last rank
    keys: np.ndarray       # (N,) f64  the sorted key column
    error: int
    epoch: int = 0
    _device_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                            repr=False, compare=False)

    def __post_init__(self):
        # enforce the class contract at construction, not just by convention:
        # every array a reader can reach through a table is non-writeable, so
        # a latent in-place mutation raises ValueError at the write site.
        # Views of caller-writeable scratch buffers are copied first (freezing
        # only the view would leave the base writable -- and alias it).
        for name in ("start_key", "slope", "base", "seg_end", "keys"):
            object.__setattr__(self, name, published_array(getattr(self, name)))

    # ----------------------------------------------------------- construction
    @classmethod
    def from_segments(cls, keys: np.ndarray, segs: "Segments",
                      error: int | None = None, epoch: int = 0) -> "SegmentTable":
        """Package a ShrinkingCone/DP output and its key column as a table.

        The key column is always copied: a table must never alias a buffer
        the caller (or the mutable tree) could write through."""
        keys = np.array(keys, np.float64, copy=True)
        base = np.asarray(segs.base, np.int64)
        seg_end = np.concatenate([base[1:], [keys.shape[0]]]).astype(np.int64)
        return cls(
            start_key=np.asarray(segs.start_key, np.float64),
            slope=np.asarray(segs.slope, np.float64),
            base=base,
            seg_end=seg_end,
            keys=keys,
            error=int(segs.error if error is None else error),
            epoch=int(epoch),
        )

    @classmethod
    def from_keys(cls, keys: np.ndarray, error: int, *, mode: "Mode" = "paper",
                  segs: "Segments | None" = None, assume_sorted: bool = False,
                  epoch: int = 0) -> "SegmentTable":
        """Segment ``keys`` (Alg. 2) and build the table in one step."""
        from repro_torch.core.segmentation import shrinking_cone  # lazy: no cycle
        keys = np.asarray(keys, np.float64)
        if keys.shape[0] == 0:
            return cls.empty(error, epoch=epoch)
        if not assume_sorted:
            keys = np.sort(keys, kind="stable")
        if segs is None:
            segs = shrinking_cone(keys, error, mode=mode)
        return cls.from_segments(keys, segs, error=error, epoch=epoch)

    @classmethod
    def from_state(cls, state) -> "SegmentTable":
        """Rebuild a table from :meth:`to_state` output (or any mapping with
        the same keys): ``start_key``, ``slope``, ``base``, ``seg_end`` and
        ``keys`` as arrays, plus ``error`` and ``epoch``.  Arrays are copied,
        so the table never aliases the caller's buffers."""
        return cls(
            start_key=np.array(state["start_key"], np.float64),
            slope=np.array(state["slope"], np.float64),
            base=np.array(state["base"], np.int64),
            seg_end=np.array(state["seg_end"], np.int64),
            keys=np.array(state["keys"], np.float64),
            error=int(state["error"]), epoch=int(state.get("epoch", 0)))

    def to_state(self) -> dict:
        """The table as plain numpy arrays and ints (read-only array views)."""
        return {"start_key": self.start_key, "slope": self.slope,
                "base": self.base, "seg_end": self.seg_end, "keys": self.keys,
                "error": self.error, "epoch": self.epoch}

    @classmethod
    def empty(cls, error: int, epoch: int = 0) -> "SegmentTable":
        """Zero-key table: one degenerate segment with an empty [0, 0) rank
        range, so routing and windows stay well-defined (every lookup misses).
        Zero segments would break ``route_keys`` (clip would wrap to -1)."""
        return cls(
            start_key=np.zeros(1, np.float64), slope=np.zeros(1, np.float64),
            base=np.zeros(1, np.int64), seg_end=np.zeros(1, np.int64),
            keys=np.empty(0, np.float64), error=int(error), epoch=int(epoch))

    # ----------------------------------------------------------------- sizing
    @property
    def n_segments(self) -> int:
        return int(self.start_key.shape[0])

    @property
    def n_keys(self) -> int:
        return int(self.keys.shape[0])

    def size_bytes(self) -> int:
        """Sec. 6.2 accounting: 24B of metadata per segment."""
        return self.n_segments * 24

    # ----------------------------------------------------------------- lookup
    def route(self, queries) -> np.ndarray:
        return route_keys(self.start_key, np.asarray(queries, np.float64))

    def _locate(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Route + interpolate: (segment id, predicted rank clamped into the
        owning segment's range so gap queries cannot overshoot).  The one
        prediction implementation (the device path mirrors it in f32)."""
        q = np.asarray(queries, np.float64)
        sid = self.route(q)
        local = np.rint((q - self.start_key[sid]) * self.slope[sid])
        pred = self.base[sid] + local.astype(np.int64)
        return sid, np.clip(pred, self.base[sid], self.seg_end[sid])

    def predict(self, queries) -> np.ndarray:
        """Predicted global ranks; within ``error`` of the true rank (Eq. 1)."""
        return self._locate(queries)[1]

    def window(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Per-query [lo, hi) rank window guaranteed to contain any present key."""
        sid, pred = self._locate(queries)
        lo = np.maximum(self.base[sid], pred - self.error)
        hi = np.minimum(self.seg_end[sid], pred + self.error + 1)
        return lo.astype(np.int64), hi.astype(np.int64)

    def page(self, sid: int) -> np.ndarray:
        """The sid-th segment's slice of the key column (a view)."""
        return self.keys[self.base[sid]:self.seg_end[sid]]

    # ------------------------------------------------------------ invariants
    def max_abs_error(self) -> float:
        """Eq. 1 check: max |predicted - true| rank over every stored key,
        each evaluated against its containing segment."""
        n = self.n_keys
        if n == 0:
            return 0.0
        true = np.arange(n, dtype=np.float64)
        sid = np.searchsorted(self.base, true, side="right") - 1
        pred = self.base[sid] + (self.keys - self.start_key[sid]) * self.slope[sid]
        return float(np.max(np.abs(pred - true)))


def numpy_lookup(table: SegmentTable, queries) -> np.ndarray:
    """Host bounded bisect over the f64 key column (the ``numpy`` engine
    backend and the tree's batch path): interpolate then log2(2*err) halving
    steps inside the window.  Returns global ranks -- the *leftmost*
    occurrence for duplicated keys -- and -1 if absent."""
    q = np.asarray(queries, np.float64)
    keys = table.keys
    n = keys.shape[0]
    if n == 0:                      # empty table: every probe misses
        return np.full(q.shape, -1, np.int64)
    lo, hi = table.window(q)
    steps = max(1, math.ceil(math.log2(2 * table.error + 2)))
    for _ in range(steps):
        mid = (lo + hi) // 2
        mid_c = np.minimum(mid, max(n - 1, 0))
        go_right = (keys[mid_c] < q) & (lo < hi)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(go_right, hi, mid)
    ok = (lo < n) & (keys[np.minimum(lo, max(n - 1, 0))] == q)
    # a duplicate run straddling a segment boundary clamps the window to the
    # routed (rightmost) segment, so the bisect lands on the in-segment
    # leftmost; snap such hits to the global leftmost occurrence (rare: only
    # when the left neighbour is also equal to the query)
    fix = ok & (lo > 0) & (keys[np.maximum(lo - 1, 0)] == q)
    if np.any(fix):
        hits = np.flatnonzero(fix)      # bisect only the queries that need it
        lo = lo.copy()
        lo.flat[hits] = np.searchsorted(keys, q.flat[hits], side="left")
    return np.where(ok, lo, -1).astype(np.int64)


def numpy_search(table: SegmentTable, queries, side: str = "left") -> np.ndarray:
    """Host bounded-window rank search: the ``numpy`` backend's primitive for
    the typed query plane (see ``repro_torch.index.query``).

    Returns ``np.searchsorted(table.keys, queries, side=side)`` -- the
    insertion rank of every query -- computed with the same interpolate +
    log2(2*err) halving steps as :func:`numpy_lookup` instead of a full-column
    bisect.  ``side="left"`` is the rank of the first key >= q (the leftmost
    occurrence when q is present), ``side="right"`` one past the last key
    <= q; every query verb (point / range / count / predecessor / successor)
    derives from these two.

    The +-error window only bounds ranks of *in-window* insertion points; a
    duplicate run straddling the routed segment (or longer than the window)
    parks the bounded result inside the run, which the side-specific snap at
    the end detects (left: the left neighbour still equals q; right: the
    landing key itself still equals q) and repairs with a full ``searchsorted``
    over just the flagged queries -- the generalization of the
    ``numpy_lookup`` leftmost fix to both sides.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    q = np.asarray(queries, np.float64)
    keys = table.keys
    n = keys.shape[0]
    if n == 0:                      # empty table: every rank is 0
        return np.zeros(q.shape, np.int64)
    if q.size <= 8:
        # tiny probes (range/predecessor bounds are 1-2 queries): one C-level
        # full-column bisect costs less than the ~log2(2e) vectorized loop
        # iterations below ever could in numpy dispatch overhead alone;
        # same contract, so the window path stays the batch implementation
        return np.searchsorted(keys, q, side=side).astype(np.int64)
    lo, hi = table.window(q)
    steps = max(1, math.ceil(math.log2(2 * table.error + 2)))
    for _ in range(steps):
        mid = (lo + hi) // 2
        mid_c = np.minimum(mid, max(n - 1, 0))
        if side == "left":
            go_right = (keys[mid_c] < q) & (lo < hi)
        else:
            go_right = (keys[mid_c] <= q) & (lo < hi)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(go_right, hi, mid)
    if side == "left":
        fix = (lo > 0) & (keys[np.maximum(lo - 1, 0)] == q)
    else:
        fix = (lo < n) & (keys[np.minimum(lo, n - 1)] == q)
    if np.any(fix):
        hits = np.flatnonzero(fix)
        lo = lo.copy()
        lo.flat[hits] = np.searchsorted(keys, q.flat[hits], side=side)
    return lo.astype(np.int64)


def shard_cut_indices(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Duplicate-safe equal-count cut indices into sorted ``keys``.

    Returns ``(n_shards,)`` strictly increasing indices with ``cuts[0] == 0``;
    shard d owns ``keys[cuts[d]:cuts[d+1]]``.  Each cut starts at an
    equal-count target (``d * n // n_shards``) and is *snapped to the start of
    the unique-key run containing it*, so a run of duplicate keys never
    straddles two shards.  Without the snap, the boundary router (which sends
    a query to the rightmost shard whose first key is <= it) and the partition
    would disagree on duplicated boundary keys and sharded lookups would lose
    the leftmost-rank contract of the single-table engines.

    When snapping left would collide with the previous cut (a duplicate run
    longer than a shard), the cut advances to the next unique-run start
    instead; raises ``ValueError`` when ``keys`` has fewer distinct values
    than ``n_shards`` (no duplicate-safe partition into non-empty shards
    exists)."""
    keys = np.asarray(keys, np.float64)
    n = keys.shape[0]
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if n < n_shards:
        raise ValueError(f"cannot cut {n} keys into "
                         f"{n_shards} non-empty shards")
    # first index of every distinct-key run (keys sorted => runs contiguous)
    run_starts = np.flatnonzero(
        np.concatenate(([True], keys[1:] != keys[:-1])))
    u = run_starts.shape[0]
    if u < n_shards:
        raise ValueError(f"cannot cut {u} distinct keys into {n_shards} "
                         f"duplicate-safe non-empty shards")
    m = n // n_shards
    cuts = np.zeros(n_shards, np.int64)
    prev = 0                        # index into run_starts of the last cut
    for j in range(1, n_shards):
        pos = int(np.searchsorted(run_starts, j * m, side="right")) - 1
        # stay ahead of the previous cut, and leave one distinct run start
        # for every remaining shard (both bounds are always satisfiable
        # because u >= n_shards)
        pos = min(max(pos, prev + 1), u - (n_shards - j))
        cuts[j] = run_starts[pos]
        prev = pos
    return cuts


def shard_boundaries(keys: np.ndarray, n_shards: int) -> np.ndarray:
    """Equal-count cut points: the first key owned by each shard.

    These are the replicated top-level router of the sharded index -- the
    paper's structure recursed once.  Routing a query through them with
    :func:`route_keys` names its owning shard; queries below the first cut
    clamp to shard 0, so the partition is total over the key space.  Cuts are
    duplicate-safe (see :func:`shard_cut_indices`): a boundary is always the
    first occurrence of its key, so equal keys all route to, and live in,
    the same shard."""
    keys = np.asarray(keys, np.float64)
    return keys[shard_cut_indices(keys, n_shards)].copy()


def shard_partition(keys: np.ndarray, n_shards: int
                    ) -> tuple[np.ndarray, list[np.ndarray]]:
    """Range-partition sorted ``keys`` into ``n_shards`` contiguous runs.

    Returns ``(boundaries, splits)`` where ``boundaries`` are the
    :func:`shard_boundaries` cuts and ``splits[d]`` is shard d's key run.
    Unlike :func:`build_shard_tables` nothing is dropped: the tail beyond the
    equal-count cut lands in the last shard, so ``concat(splits) == keys``
    and a shard's global rank offset is the summed length of its
    predecessors.  Cuts snap to unique-key run starts
    (:func:`shard_cut_indices`), so no duplicate run straddles a shard."""
    keys = np.asarray(keys, np.float64)
    cuts = shard_cut_indices(keys, n_shards)
    return keys[cuts].copy(), np.split(keys, cuts[1:])


def build_shard_tables(keys: np.ndarray, error: int, n_shards: int,
                       mode: "Mode" = "paper") -> list[SegmentTable]:
    """Equal-count contiguous range partition: one independent SegmentTable per
    shard (local ranks).  The tail beyond ``n_shards * (n // n_shards)`` is
    dropped, as in the original sharded build (callers handle it); the
    serving-side partition that keeps every key is :func:`shard_partition`.
    Cuts here are *rectangular*, not duplicate-safe: the (D, M) device layout
    requires equal shard sizes, so the distributed path assumes distinct keys
    (its tests and datasets are duplicate-free)."""
    keys = np.asarray(keys, np.float64)
    m = keys.shape[0] // n_shards
    shards = keys[: m * n_shards].reshape(n_shards, m)
    return [SegmentTable.from_keys(s, error, mode=mode, assume_sorted=True)
            for s in shards]
