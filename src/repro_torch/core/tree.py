"""FITing-Tree / A-Tree: the host-side index structure (Secs. 2, 4, 5).

Layout (clustered index, Fig. 2):
  * table data is partitioned into *variable-sized pages*, one per segment;
  * per segment we keep (start_key, slope) -- 24B of metadata in the paper's
    accounting -- organized in an array-packed router (the paper's inner B+ tree;
    packed arrays stand in for pointer-chasing);
  * each page carries a bounded sorted insert buffer (Sec. 5); the segmentation
    error budget is transparently err_seg = error - buffer_size so the
    user-visible bound still holds when elements sit in the buffer.

Lookup (Alg. 3): router -> segment, interpolate, binary-search the +-err window
of the page, then the buffer.  Insert (Alg. 4): append to the buffer; on
overflow merge + re-run ShrinkingCone and splice the new segments in.

A non-clustered index (Fig. 3) is the same structure over the *sorted key
column* with a parallel payload array per page (pointers into the table).

Port of ``repro.core.tree``: host numpy code, copied so the torch package
never imports the JAX package.  Its pages, segments and answers are
bit-identical to it.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
import math

import numpy as np

from repro_torch.index.table import (SegmentTable, numpy_lookup, numpy_search,
                               route_keys)

from .segmentation import Mode, Segments, _finalize, shrinking_cone


class PackedRouter:
    """Array-packed static B+-tree over segment start keys.

    Semantically equivalent to searchsorted over the leaf array (tests assert
    this); exists to make the paper's log_b(S) tree-search term concrete:
    ``height`` and ``size_bytes`` feed the Sec. 6 cost model.
    """

    def __init__(self, leaf_keys: np.ndarray, fanout: int = 16):
        self.fanout = fanout
        self.levels: list[np.ndarray] = [np.asarray(leaf_keys, np.float64)]
        while self.levels[-1].shape[0] > fanout:
            self.levels.append(self.levels[-1][::fanout])
        self.levels.reverse()  # levels[0] = root

    @property
    def height(self) -> int:
        return len(self.levels)

    def size_bytes(self) -> int:
        # 8B key + 8B pointer per entry, all levels (pessimistic, like Sec. 6.2)
        return int(sum(lvl.shape[0] for lvl in self.levels) * 16)

    def descend(self, keys: np.ndarray) -> np.ndarray:
        """Batched level-by-level descent."""
        keys = np.asarray(keys, np.float64)
        node = np.zeros(keys.shape[0], dtype=np.int64)
        b = self.fanout
        for d, lvl in enumerate(self.levels):
            lo = node * b
            hi = np.minimum(lo + b, lvl.shape[0])
            # branchless binary search inside each node slice
            child = lo.copy()
            span = int(np.max(hi - lo)) if lvl.shape[0] else 0
            steps = max(1, math.ceil(math.log2(max(2, span))))
            lo_i, hi_i = lo.copy(), hi.copy()
            for _ in range(steps + 1):
                mid = (lo_i + hi_i) // 2
                mid_c = np.minimum(mid, lvl.shape[0] - 1)
                go_right = (lvl[mid_c] <= keys) & (lo_i < hi_i)
                lo_i = np.where(go_right, mid + 1, lo_i)
                hi_i = np.where(go_right, hi_i, mid)
            child = np.maximum(lo_i - 1, 0)
            node = child
        return node


def _merge_sorted(page: np.ndarray, run: np.ndarray,
                  pl_page: np.ndarray | None = None,
                  pl_run: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray | None]:
    """Stable two-way merge of two sorted key arrays (+ parallel payloads).

    ``page`` elements come first among equal keys (side="right"), matching
    the Alg. 4 buffer-merge semantics."""
    merged = np.empty(page.shape[0] + run.shape[0], np.float64)
    pos = np.searchsorted(page, run, side="right") + np.arange(run.shape[0])
    mask = np.zeros(merged.shape[0], bool)
    mask[pos] = True
    merged[mask] = run
    merged[~mask] = page
    pl_merged = None
    if pl_page is not None:
        pl_merged = np.empty(merged.shape[0], pl_page.dtype)
        pl_merged[mask] = pl_run
        pl_merged[~mask] = pl_page
    return merged, pl_merged


def _paginate(arr: np.ndarray, pl: np.ndarray | None, segs: Segments
              ) -> tuple[list[np.ndarray], list[np.ndarray] | None]:
    """Slice a merged sorted run into per-segment pages (+ payload pages)."""
    bounds = np.concatenate([segs.base, [arr.shape[0]]]).astype(np.int64)
    pages = [arr[bounds[i]:bounds[i + 1]] for i in range(segs.n_segments)]
    pl_pages = (None if pl is None else
                [pl[bounds[i]:bounds[i + 1]] for i in range(segs.n_segments)])
    return pages, pl_pages


def _empty_segments(error: int) -> Segments:
    """One degenerate zero-count segment: keeps routing well-defined for an
    empty tree (mirrors ``SegmentTable.empty``)."""
    return Segments(start_key=np.zeros(1, np.float64),
                    slope=np.zeros(1, np.float64),
                    base=np.zeros(1, np.int64),
                    count=np.zeros(1, np.int64), error=int(error))


class FITingTree:
    """The paper's index.  ``error`` is the user-visible max-error bound."""

    def __init__(self, keys: np.ndarray, error: int, buffer_size: int = 0,
                 mode: Mode = "paper", payload: np.ndarray | None = None,
                 fanout: int = 16, assume_sorted: bool = False):
        keys = np.asarray(keys, np.float64)
        if not assume_sorted:
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            if payload is not None:
                payload = np.asarray(payload)[order]
        if buffer_size >= error:
            raise ValueError("buffer_size must be < error (Sec. 5)")
        self.error = int(error)
        self.buffer_size = int(buffer_size)
        self.err_seg = int(error - buffer_size) if buffer_size else int(error)
        self.mode: Mode = mode
        self.fanout = fanout
        self.clustered = payload is None

        segs = (_empty_segments(self.err_seg) if keys.shape[0] == 0 else
                shrinking_cone(keys, self.err_seg, mode=mode))
        self._init_pages(keys, payload, segs)

    # ------------------------------------------------------------------ build
    def _init_pages(self, keys, payload, segs: Segments):
        table = SegmentTable.from_segments(keys, segs, error=self.err_seg)
        self.start_keys = table.start_key.copy()
        self.slopes = table.slope.copy()
        self.pages = [table.page(i) for i in range(table.n_segments)]
        self.payloads = (None if payload is None else
                         [payload[table.base[i]:table.seg_end[i]]
                          for i in range(table.n_segments)])
        self.buffers: list[list[float]] = [[] for _ in range(table.n_segments)]
        self.buf_payloads: list[list] = [[] for _ in range(table.n_segments)]
        self.router = PackedRouter(self.start_keys, self.fanout)
        self._flat_cache = None
        self._table_cache: SegmentTable | None = table

    # ----------------------------------------------------------------- sizing
    @property
    def n_segments(self) -> int:
        return len(self.pages)

    @property
    def n_keys(self) -> int:
        return int(sum(p.shape[0] for p in self.pages) + sum(len(b) for b in self.buffers))

    def index_size_bytes(self) -> int:
        """Sec. 6.2 accounting: segment metadata + router (tree) size."""
        return self.n_segments * 24 + self.router.size_bytes()

    # ----------------------------------------------------------------- lookup
    def _segment_of(self, key: float) -> int:
        return int(route_keys(self.start_keys, key))

    def _window(self, sid: int, key: float) -> tuple[int, int, int]:
        page = self.pages[sid]
        pred = (key - self.start_keys[sid]) * self.slopes[sid]
        pred_i = int(round(pred))
        lo = max(0, pred_i - self.err_seg)
        hi = min(page.shape[0], pred_i + self.err_seg + 1)
        return lo, hi, pred_i

    def lookup(self, key: float):
        """Alg. 3.  Returns (segment_id, offset, payload|None) or None if absent."""
        sid = self._segment_of(key)
        page = self.pages[sid]
        lo, hi, _ = self._window(sid, key)
        off = lo + int(np.searchsorted(page[lo:hi], key, side="left"))
        if off < hi and off < page.shape[0] and page[off] == key:
            val = None if self.payloads is None else self.payloads[sid][off]
            return (sid, off, val)
        buf = self.buffers[sid]
        j = bisect.bisect_left(buf, key)
        if j < len(buf) and buf[j] == key:
            val = None if self.payloads is None else self.buf_payloads[sid][j]
            return (sid, -(j + 1), val)
        return None

    def lookup_batch(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized membership probe over the *pages* (buffers excluded; the
        benchmark path).  Delegates to the canonical numpy backend over the
        page snapshot: interpolate then log2(2*err) halving steps, exactly as
        the device engines do.  Returns the global rank of each found key, -1 if
        absent from pages."""
        return numpy_lookup(self.as_table(), keys)

    def _flat_view(self):
        if getattr(self, "_flat_cache", None) is None:
            counts = np.asarray([p.shape[0] for p in self.pages], np.int64)
            bases = np.concatenate([[0], np.cumsum(counts)[:-1]])
            self._flat_cache = (np.concatenate(self.pages), bases)
        return self._flat_cache

    def as_table(self, epoch: int = 0) -> SegmentTable:
        """Immutable SegmentTable over the current pages (buffers excluded).

        The table satisfies Eq. 1 with the segmentation budget err_seg, so any
        ``repro_torch.index.engine`` backend can serve it.  Cached until the next
        mutation; the returned snapshot never aliases mutable state."""
        if getattr(self, "_table_cache", None) is None:
            flat, bases = self._flat_view()
            counts = np.asarray([p.shape[0] for p in self.pages], np.int64)
            self._table_cache = SegmentTable(
                start_key=self.start_keys.copy(), slope=self.slopes.copy(),
                base=bases.astype(np.int64),
                seg_end=(bases + counts).astype(np.int64),
                keys=flat, error=self.err_seg)
        t = self._table_cache
        return t if t.epoch == epoch else dataclasses.replace(t, epoch=epoch)

    def payload_column(self) -> np.ndarray | None:
        """Payload column parallel to ``as_table().keys`` (pages only --
        callers that need buffered payloads flush first, as the publisher
        does).  None for a clustered index; always a fresh array, so a
        snapshot holding it never aliases mutable tree state."""
        if self.payloads is None:
            return None
        return np.concatenate(self.payloads) if self.payloads else \
            np.empty(0)

    def range_query(self, lo_key: float, hi_key: float) -> np.ndarray:
        """Sec. 4.2 range scan: thin wrapper over the typed query plane.

        The page half delegates to the plane's bounded rank search
        (``repro_torch.index.table.numpy_search`` -- the ``[lo, hi]``-inclusive
        contract of ``repro_torch.index.query``: leftmost rank at ``lo``, rightmost
        at ``hi``), which also fixes the legacy scan's blind spot: it started
        at ``lo_key``'s *routed* segment, silently dropping duplicates of
        ``lo_key`` whose run began in an earlier segment.  Buffered inserts
        (invisible to the page snapshot) merge on top, as before."""
        if hi_key < lo_key:
            return np.empty(0, np.float64)
        table = self.as_table()
        bounds = np.asarray([lo_key, hi_key], np.float64)
        lo_rank = int(numpy_search(table, bounds[:1], "left")[0])
        hi_rank = max(int(numpy_search(table, bounds[1:], "right")[0]), lo_rank)
        out = [table.keys[lo_rank:hi_rank]]
        for sid in self.dirty_segments():
            buf = self.buffers[sid]
            i = bisect.bisect_left(buf, lo_key)
            j = bisect.bisect_right(buf, hi_key)
            if i < j:
                out.append(np.asarray(buf[i:j], np.float64))
        return np.sort(np.concatenate(out))

    # ----------------------------------------------------------------- insert
    def insert(self, key: float, value=None) -> None:
        """Alg. 4: buffer the key; merge + re-segment on overflow."""
        self.insert_many([key], [value])

    def insert_many(self, keys, values=None) -> None:
        """Alg. 4 over a batch, in arrival order, with the batch routed at
        once (``insert`` is a batch of one).

        An overflow re-fits a segment into segments that start at keys of
        its merged run, so they cover the old segment's key range and no
        other: a key routed to a segment stays among that segment's
        replacements.  Each touched segment therefore takes its keys in
        arrival order, merges (Alg. 4 lines 5-9) at the key that fills its
        buffer and routes the keys after it among its replacements; the
        segment arrays are spliced and the router rebuilt once."""
        if self.buffer_size == 0:
            raise ValueError("tree built read-only (buffer_size=0)")
        keys = np.asarray(keys, np.float64).ravel()
        n = keys.shape[0]
        if values is not None and len(values) != n:
            raise ValueError(f"{len(values)} values for {n} keys")
        if n == 0:
            return
        vals = [None] * n if values is None else list(values)
        sids = route_keys(self.start_keys, keys)
        order = np.argsort(sids, kind="stable")
        grouped = sids[order]
        cuts = np.flatnonzero(np.diff(grouped)) + 1
        klist = keys.tolist()
        replaced = {}
        for a, b in zip(np.r_[0, cuts].tolist(), np.r_[cuts, n].tolist()):
            sid = int(grouped[a])
            idx = order[a:b].tolist()
            ks, vs = [klist[i] for i in idx], [vals[i] for i in idx]
            if len(self.buffers[sid]) + len(ks) < self.buffer_size:
                self._buffer(self.buffers[sid], self.buf_payloads[sid], ks, vs)
            else:                           # overflows at one key at least
                replaced[sid] = self._insert_group(sid, ks, vs)
        self._flat_cache = None
        self._table_cache = None
        if replaced:
            self._splice(replaced)

    def _buffer(self, buf: list, buf_pl: list, ks: list, vs: list) -> None:
        """Alg. 4 lines 1-4 for keys that fit the buffer: sorted inserts,
        a key before its equals."""
        for k, v in zip(ks, vs):
            j = bisect.bisect_left(buf, k)
            buf.insert(j, k)
            if self.payloads is not None:
                buf_pl.insert(j, v)

    def _insert_group(self, sid: int, ks: list, vs: list):
        """One segment's keys in arrival order, each overflow merged at the
        key that fills the buffer.  Returns the segment's replacements:
        (start keys, slopes, pages, payload pages, buffers, buffer
        payloads)."""
        starts = [float(self.start_keys[sid])]
        slopes = [float(self.slopes[sid])]
        pages = [self.pages[sid]]
        pls = [None if self.payloads is None else self.payloads[sid]]
        bufs = [self.buffers[sid]]
        bpls = [self.buf_payloads[sid]]
        for k, v in zip(ks, vs):
            j = max(bisect.bisect_right(starts, k) - 1, 0)
            self._buffer(bufs[j], bpls[j], [k], [v])
            if len(bufs[j]) < self.buffer_size:
                continue
            g = self._replacement(*self._refit_run(pages[j], bufs[j], pls[j],
                                                   bpls[j]))
            starts[j:j + 1] = g[0].tolist()
            slopes[j:j + 1] = g[1].tolist()
            pages[j:j + 1], pls[j:j + 1] = g[2], g[3]
            bufs[j:j + 1], bpls[j:j + 1] = g[4], g[5]
        return (np.asarray(starts, np.float64), np.asarray(slopes, np.float64),
                pages, pls, bufs, bpls)

    def _replacement(self, pages: list, pls: list | None, segs) -> tuple:
        """A re-fit run's segments as a group for :meth:`_splice`, their
        buffers empty."""
        m = segs.n_segments
        return (segs.start_key, segs.slope, list(pages),
                [None] * m if pls is None else list(pls),
                [[] for _ in range(m)], [[] for _ in range(m)])

    def _splice(self, replaced: dict) -> None:
        """Put each replaced segment's group (start keys, slopes, pages,
        payload pages, buffers, buffer payloads) in its place: one pass,
        one metadata concat, one router rebuild."""
        pages, payloads, buffers, buf_pls = [], [], [], []
        start_keys, slopes = [], []
        prev = 0
        for sid in sorted(replaced):
            g_starts, g_slopes, g_pages, g_pls, g_bufs, g_bpls = replaced[sid]
            pages += self.pages[prev:sid] + g_pages
            buffers += self.buffers[prev:sid] + g_bufs
            buf_pls += self.buf_payloads[prev:sid] + g_bpls
            if self.payloads is not None:
                payloads += self.payloads[prev:sid] + g_pls
            start_keys += [self.start_keys[prev:sid], g_starts]
            slopes += [self.slopes[prev:sid], g_slopes]
            prev = sid + 1
        self.pages = pages + self.pages[prev:]
        self.buffers = buffers + self.buffers[prev:]
        self.buf_payloads = buf_pls + self.buf_payloads[prev:]
        if self.payloads is not None:
            self.payloads = payloads + self.payloads[prev:]
        self.start_keys = np.concatenate(start_keys + [self.start_keys[prev:]])
        self.slopes = np.concatenate(slopes + [self.slopes[prev:]])
        self.router = PackedRouter(self.start_keys, self.fanout)

    def dirty_segments(self) -> list[int]:
        """Segments whose insert buffer holds keys not yet merged into pages."""
        return [sid for sid, buf in enumerate(self.buffers) if buf]

    def flush(self, device=None) -> int:
        """Merge every non-empty insert buffer into its page (Alg. 4 lines
        5-9 applied per dirty segment), re-segmenting only those runs.  The
        publish path (repro_torch.index.snapshot); returns #segments re-fit.

        Every dirty run is merged at once and fitted by one call of
        ``shrinking_cone_runs`` on ``device``: the card's kernel for a CUDA
        device, its host twin for the CPU (None).  Each run's first key
        opens a segment, so no segment crosses a run, and the segments,
        pages and slopes are those of ``shrinking_cone`` run by run.  All
        splices land in one pass (one metadata reconcat + one router
        rebuild), so the cost is O(dirty work + S), not O(dirty * S)."""
        dirty = self.dirty_segments()
        if not dirty:
            return 0
        import torch      # lazy: the tree module loads without torch
        from repro_torch.kernels.shrinking_cone import shrinking_cone_runs
        merged, pl_merged, offsets = self._merge_dirty(dirty)
        dev = torch.device("cpu" if device is None else device)
        keys = torch.from_numpy(merged)
        is_start, slope = shrinking_cone_runs(
            keys if dev.type == "cpu" else keys.to(dev), offsets,
            self.err_seg, self.mode)
        starts = np.flatnonzero(is_start.cpu().numpy())
        segs = _finalize(merged, starts, self.err_seg,
                         None if slope is None else slope.cpu().numpy()[starts])
        # each page its own copy: a view would keep the whole merged array
        # alive while any one of its pages survives later publishes
        bounds = np.append(starts, merged.shape[0]).tolist()
        cuts = list(zip(bounds[:-1], bounds[1:]))
        pages = [merged[a:b].copy() for a, b in cuts]
        pls = (None if pl_merged is None else
               [pl_merged[a:b].copy() for a, b in cuts])
        first = np.searchsorted(starts, offsets).tolist()  # a run's segments
        replaced = {}
        for sid, a, b in zip(dirty, first[:-1], first[1:]):
            replaced[sid] = (segs.start_key[a:b], segs.slope[a:b], pages[a:b],
                             [None] * (b - a) if pls is None else pls[a:b],
                             [[] for _ in range(b - a)],
                             [[] for _ in range(b - a)])
        self._splice(replaced)
        self._flat_cache = None
        self._table_cache = None
        return len(dirty)

    def _merge_dirty(self, dirty: list[int]):
        """Alg. 4 lines 5-7's merge for every dirty segment at once: the
        dirty pages and buffers concatenated in segment order, each buffer
        key placed in its own segment's page after the page's equal keys.
        Returns (merged keys, merged payloads|None, run offsets)."""
        pages = [self.pages[s] for s in dirty]
        bufs = [self.buffers[s] for s in dirty]
        n_page = np.fromiter((p.shape[0] for p in pages), np.int64, len(dirty))
        n_buf = np.fromiter((len(b) for b in bufs), np.int64, len(dirty))
        page_keys = np.concatenate(pages)
        buf_keys = np.fromiter(itertools.chain.from_iterable(bufs),
                               np.float64, int(n_buf.sum()))
        p_end = np.cumsum(n_page)
        run = np.repeat(np.arange(len(dirty)), n_buf)
        # the pages are sorted across segments, so a global search clipped
        # to the key's own page is that page's side="right" search
        at = np.clip(np.searchsorted(page_keys, buf_keys, side="right"),
                     (p_end - n_page)[run], p_end[run])
        offsets = np.concatenate([[0], np.cumsum(n_page + n_buf)])
        merged = np.insert(page_keys, at, buf_keys)
        if self.payloads is None:
            return merged, None, offsets
        pl_page = np.concatenate([self.payloads[s] for s in dirty])
        pl_buf = np.asarray(list(itertools.chain.from_iterable(
            self.buf_payloads[s] for s in dirty)), dtype=pl_page.dtype)
        return merged, np.insert(pl_page, at, pl_buf), offsets

    def _refit_run(self, page: np.ndarray, buffer: list,
                   pl_page: np.ndarray | None, buf_pl: list):
        """Merge one buffer into its page and re-fit the run (Alg. 4 lines
        5-7): (pages, payloads|None, segs) of the replacements."""
        buf = np.asarray(buffer, np.float64)
        pl_buf = (None if pl_page is None else
                  np.asarray(buf_pl, dtype=pl_page.dtype))
        merged, pl_merged = _merge_sorted(page, buf, pl_page, pl_buf)
        segs = shrinking_cone(merged, self.err_seg, mode=self.mode)
        new_pages, new_payloads = _paginate(merged, pl_merged, segs)
        return new_pages, new_payloads, segs

    # ----------------------------------------------- shard migration (splice)
    def extract_range(self, lo_key: float, hi_key: float
                      ) -> tuple[np.ndarray, np.ndarray | None]:
        """Remove and return every key in ``[lo_key, hi_key)`` (+ payloads).

        The donor half of shard rebalancing: buffers are flushed first so the
        page view is complete, segments fully inside the range are handed
        over wholesale, and a segment only partially covered is re-segmented
        over its surviving keys (everything else keeps its fitted line, so
        Eq. 1 still holds with err_seg).  Returns ``(keys, payloads)`` sorted
        ascending; ``payloads`` is ``None`` for a clustered index.  Extracting
        everything leaves a valid empty tree that ``splice_run`` / ``insert``
        can refill."""
        if hi_key < lo_key:        # inverted slices would duplicate keys
            raise ValueError(f"inverted extract range: [{lo_key}, {hi_key})")
        self.flush()
        out_k: list[np.ndarray] = []
        out_p: list[np.ndarray] = []
        pages, payloads, start_keys, slopes = [], [], [], []
        for sid in range(self.n_segments):
            page = self.pages[sid]
            a = int(np.searchsorted(page, lo_key, side="left"))
            b = int(np.searchsorted(page, hi_key, side="left"))
            pl = None if self.payloads is None else self.payloads[sid]
            if a == b:                               # untouched: keep the fit
                pages.append(page)
                start_keys.append(self.start_keys[sid:sid + 1])
                slopes.append(self.slopes[sid:sid + 1])
                if pl is not None:
                    payloads.append(pl)
                continue
            out_k.append(page[a:b].copy())
            if pl is not None:
                out_p.append(pl[a:b].copy())
            rest = np.concatenate([page[:a], page[b:]])
            if rest.shape[0] == 0:                   # fully extracted: drop
                continue
            rest_pl = None if pl is None else np.concatenate([pl[:a], pl[b:]])
            segs = shrinking_cone(rest, self.err_seg, mode=self.mode)
            pgs, pls = _paginate(rest, rest_pl, segs)
            pages += pgs
            start_keys.append(segs.start_key)
            slopes.append(segs.slope)
            if pls is not None:
                payloads += pls
        if not pages:                                # tree is now empty
            pages = [np.empty(0, np.float64)]
            start_keys = [np.zeros(1, np.float64)]
            slopes = [np.zeros(1, np.float64)]
            if self.payloads is not None:
                payloads = [out_p[0][:0]]
        self.pages = pages
        if self.payloads is not None:
            self.payloads = payloads
        self.buffers = [[] for _ in pages]           # flush() emptied them
        self.buf_payloads = [[] for _ in pages]
        self.start_keys = np.concatenate(start_keys)
        self.slopes = np.concatenate(slopes)
        self.router = PackedRouter(self.start_keys, self.fanout)
        self._flat_cache = None
        self._table_cache = None
        keys_out = (np.concatenate(out_k) if out_k else
                    np.empty(0, np.float64))
        pl_out = (None if self.payloads is None else
                  np.concatenate(out_p) if out_p else
                  self.payloads[0][:0])
        return keys_out, pl_out

    def splice_run(self, keys: np.ndarray,
                   payload: np.ndarray | None = None) -> None:
        """Merge a sorted key run (+ payloads) into the tree in bulk.

        The receiving half of shard rebalancing: only the segments whose key
        range overlaps the run are merged and re-segmented (Alg. 4 lines 5-9
        applied to the spliced span); every other segment keeps its fitted
        line.  Unlike ``insert`` this does not require an insert buffer, so
        read-only trees can be rebalanced too."""
        keys = np.asarray(keys, np.float64)
        if self.clustered and payload is not None:
            raise ValueError("tree built without payloads (clustered index); "
                             "cannot splice a payload run")
        if not self.clustered and payload is None:
            raise ValueError("non-clustered tree: splice_run needs the "
                             "payload run alongside the keys")
        if keys.shape[0] == 0:
            return
        if payload is not None and len(payload) != keys.shape[0]:
            raise ValueError("payload run length must match the key run")
        self.flush()
        if self.n_keys == 0:                         # refill an emptied tree
            segs = shrinking_cone(keys, self.err_seg, mode=self.mode)
            self._init_pages(keys.copy(), payload, segs)
            return
        s0 = self._segment_of(float(keys[0]))
        s1 = self._segment_of(float(keys[-1]))
        span = np.concatenate(self.pages[s0:s1 + 1])
        pl_span = (None if self.payloads is None else
                   np.concatenate(self.payloads[s0:s1 + 1]))
        pl_run = (None if payload is None else
                  np.asarray(payload, dtype=pl_span.dtype))
        merged, pl_merged = _merge_sorted(span, keys, pl_span, pl_run)
        segs = shrinking_cone(merged, self.err_seg, mode=self.mode)
        k = segs.n_segments
        pgs, pls = _paginate(merged, pl_merged, segs)
        self.pages[s0:s1 + 1] = pgs
        self.buffers[s0:s1 + 1] = [[] for _ in range(k)]
        self.buf_payloads[s0:s1 + 1] = [[] for _ in range(k)]
        if self.payloads is not None:
            self.payloads[s0:s1 + 1] = pls
        self.start_keys = np.concatenate([
            self.start_keys[:s0], segs.start_key, self.start_keys[s1 + 1:]])
        self.slopes = np.concatenate([
            self.slopes[:s0], segs.slope, self.slopes[s1 + 1:]])
        self.router = PackedRouter(self.start_keys, self.fanout)
        self._flat_cache = None
        self._table_cache = None

    # ------------------------------------------------------------ invariants
    def max_abs_error(self) -> float:
        """Verify Eq. 1 over every page element (buffers are covered by the
        err_seg + buffer_size <= error budget, Sec. 5).  Delegates to the
        canonical check on the page snapshot."""
        return self.as_table().max_abs_error()
