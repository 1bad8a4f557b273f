"""Error-bounded piece-wise-linear segmentation (FITing-Tree / A-Tree, Secs. 3.2-3.4).

Port of ``repro.core.segmentation``: host numpy code, copied so the torch
package never imports the JAX package.  Outputs are bit-identical to it.

A *segment* is a maximal run of (key, position) points such that every point is
within `error` positions of the line through the segment's first and last point
(the E-infinity objective of Sec. 3.1, Eq. 1).

Implements:
  * ``shrinking_cone``      -- Alg. 2 (greedy one-pass, O(n) time / O(1) state),
                               numpy-accelerated with adaptive chunking.
  * ``shrinking_cone_py``   -- line-by-line readable reference of Alg. 2 (tests
                               cross-check the fast version against this).
  * ``optimal_segmentation``-- Alg. 1 (DP, O(n^2) time via cumulative cone rows).
  * ``Segments``            -- the packed array output (start_key, slope, base, count).
  * ``verify_segments``     -- vectorized check of the error invariant (Eq. 1).

Modes:
  * ``mode="paper"``   (default): a point joins a segment iff the *endpoint-defined*
    slope lies inside the cone (this is the paper's Alg. 2 / Fig. 5 semantics; the
    final segment slope is the slope to the last point, which Theorem-3.1-style
    argument shows respects the bound for every interior point).
  * ``mode="clamped"`` (beyond-paper): a point joins iff its feasible slope interval
    intersects the cone; the final slope is the endpoint slope clamped into the
    remaining cone.  Strictly-no-worse segment lengths; see EXPERIMENTS.md SPerf.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

Mode = Literal["paper", "clamped"]

_INF = np.inf


@dataclasses.dataclass(frozen=True)
class Segments:
    """Packed piece-wise-linear index: position ~ base[s] + (key - start_key[s]) * slope[s]."""

    start_key: np.ndarray  # (S,) float64 -- first key of each segment
    slope: np.ndarray      # (S,) float64 -- positions per key unit
    base: np.ndarray       # (S,) int64   -- position of the first key of the segment
    count: np.ndarray      # (S,) int64   -- number of elements covered
    error: int             # the bound the segmentation was built with

    @property
    def n_segments(self) -> int:
        return int(self.start_key.shape[0])

    def size_bytes(self) -> int:
        """Paper Sec. 6.2: 24B of metadata per segment (start key, slope, pointer)."""
        return self.n_segments * 24

    def predict(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized predicted positions for (sorted or unsorted) query keys."""
        keys = np.asarray(keys, dtype=np.float64)
        sid = np.searchsorted(self.start_key, keys, side="right") - 1
        sid = np.clip(sid, 0, self.n_segments - 1)
        pred = self.base[sid] + (keys - self.start_key[sid]) * self.slope[sid]
        return pred

    def segment_of(self, keys: np.ndarray) -> np.ndarray:
        sid = np.searchsorted(self.start_key, np.asarray(keys, np.float64), side="right") - 1
        return np.clip(sid, 0, self.n_segments - 1)


def _finalize(xs: np.ndarray, starts: np.ndarray, error: int,
              slopes: np.ndarray | None = None) -> Segments:
    """Build the packed Segments from start indices (and optional explicit slopes)."""
    starts = np.asarray(starts, dtype=np.int64)
    n = xs.shape[0]
    ends = np.empty_like(starts)
    ends[:-1] = starts[1:] - 1
    ends[-1] = n - 1
    x0 = xs[starts]
    x1 = xs[ends]
    dx = x1 - x0
    dy = (ends - starts).astype(np.float64)
    if slopes is None:
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            slopes = np.where(dx > 0, dy / np.where(dx > 0, dx, 1.0), 0.0)
    # subnormal key spans can overflow the slope to inf; a clamped slope keeps
    # predictions finite and within the bound ((k - start) <= dx, so
    # pred <= dx * SLOPE_MAX stays ~0 for such segments)
    slopes = np.clip(np.nan_to_num(np.asarray(slopes, np.float64),
                                   posinf=1e300, neginf=0.0), 0.0, 1e300)
    return Segments(
        start_key=x0.astype(np.float64),
        slope=np.asarray(slopes, np.float64),
        base=starts,
        count=(ends - starts + 1),
        error=int(error),
    )


def shrinking_cone_py(xs: np.ndarray, error: int, mode: Mode = "paper") -> Segments:
    """Readable reference implementation of Alg. 2 (ShrinkingCone).

    ``xs`` must be sorted ascending (duplicates allowed); positions are 0..n-1.
    """
    xs = np.asarray(xs, dtype=np.float64)
    n = xs.shape[0]
    if n == 0:
        raise ValueError("empty key array")
    starts = [0]
    clamped_slopes = []  # only used in mode="clamped"
    ox, oy = xs[0], 0.0          # cone origin (Alg. 2 line 3)
    sl_hi, sl_lo = _INF, 0.0     # Alg. 2 lines 1-2
    last = 0
    for i in range(1, n):
        x, y = xs[i], float(i)
        dx, dy = x - ox, y - oy
        if dx == 0.0:
            ok = dy <= error      # duplicate key: any slope predicts oy; need |dy|<=err
            if ok:
                last = i
                continue
            s = _INF
            lo_cand = hi_cand = _INF
        else:
            s = dy / dx
            hi_cand = (dy + error) / dx
            lo_cand = (dy - error) / dx
            ok = (sl_lo <= s <= sl_hi) if mode == "paper" else (
                lo_cand <= sl_hi and hi_cand >= sl_lo)
        if ok:
            sl_hi = min(sl_hi, hi_cand)
            sl_lo = max(sl_lo, lo_cand)
            last = i
        else:  # Alg. 2 lines 8-10: close the segment, new cone at (x, y)
            if mode == "clamped":
                clamped_slopes.append(_close_slope(xs, starts[-1], last, sl_lo, sl_hi))
            starts.append(i)
            ox, oy = x, y
            sl_hi, sl_lo = _INF, 0.0
            last = i
    if mode == "clamped":
        clamped_slopes.append(_close_slope(xs, starts[-1], last, sl_lo, sl_hi))
        return _finalize(xs, np.array(starts), error, np.array(clamped_slopes))
    return _finalize(xs, np.array(starts), error)


def _close_slope(xs, s0, s1, sl_lo, sl_hi) -> float:
    """Endpoint slope clamped into the final cone (mode="clamped")."""
    dx = xs[s1] - xs[s0]
    if dx <= 0:
        return 0.0
    with np.errstate(over="ignore", divide="ignore"):
        s = (s1 - s0) / dx
    if not np.isfinite(s):
        s = 1e300            # subnormal span: see _finalize slope clamp
    hi = sl_hi if np.isfinite(sl_hi) else s
    return float(min(max(s, sl_lo), max(hi, sl_lo), 1e300))


def shrinking_cone(xs: np.ndarray, error: int, mode: Mode = "paper") -> Segments:
    """numpy-accelerated Alg. 2 with adaptive chunking.

    Sequentially scans the keys but evaluates the cone update in vectorized
    chunks; on a segment break the chunk restarts at the break point with a
    small chunk that grows geometrically (exponential-search style), so the
    overhead stays O(1)x even when segments are short.
    """
    xs = np.asarray(xs, dtype=np.float64)
    n = xs.shape[0]
    if n == 0:
        raise ValueError("empty key array")
    ys = np.arange(n, dtype=np.float64)
    starts: list[int] = [0]
    slopes: list[float] = []
    use_clamped = mode == "clamped"

    cur = 0          # origin index of the open segment
    pos = 1          # next index to examine
    sl_hi, sl_lo = _INF, 0.0
    chunk = 64
    CHUNK_MAX = 8192
    while pos < n:
        hi = min(n, pos + chunk)
        dx = xs[pos:hi] - xs[cur]
        dy = ys[pos:hi] - ys[cur]
        dup = dx == 0.0
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            s = np.where(dup, _INF, dy / np.where(dup, 1.0, dx))
            hi_cand = np.where(dup, _INF, (dy + error) / np.where(dup, 1.0, dx))
            lo_cand = np.where(dup, -_INF, (dy - error) / np.where(dup, 1.0, dx))
        # cone state *before* adding element i = cumulative over previous elements
        hi_acc = np.minimum.accumulate(np.concatenate(([sl_hi], hi_cand))[:-1])
        lo_acc = np.maximum.accumulate(np.concatenate(([sl_lo], lo_cand))[:-1])
        if use_clamped:
            ok = np.where(dup, dy <= error, (lo_cand <= hi_acc) & (hi_cand >= lo_acc))
        else:
            ok = np.where(dup, dy <= error, (lo_acc <= s) & (s <= hi_acc))
        bad = np.nonzero(~ok)[0]
        if bad.size == 0:
            sl_hi = min(sl_hi, float(np.min(hi_cand)))
            sl_lo = max(sl_lo, float(np.max(lo_cand)))
            pos = hi
            chunk = min(CHUNK_MAX, chunk * 2)
        else:
            b = int(bad[0])
            if b > 0:
                sl_hi = min(sl_hi, float(np.min(hi_cand[:b])))
                sl_lo = max(sl_lo, float(np.max(lo_cand[:b])))
            brk = pos + b
            if use_clamped:
                slopes.append(_close_slope(xs, cur, brk - 1, sl_lo, sl_hi))
            starts.append(brk)
            cur = brk
            pos = brk + 1
            sl_hi, sl_lo = _INF, 0.0
            chunk = 64
    if use_clamped:
        slopes.append(_close_slope(xs, cur, n - 1, sl_lo, sl_hi))
        return _finalize(xs, np.array(starts), error, np.array(slopes))
    return _finalize(xs, np.array(starts), error)


def optimal_segmentation(xs: np.ndarray, error: int,
                         return_segments: bool = False) -> int | Segments:
    """Alg. 1: DP over 'minimum segments covering keys[0..k]'.

    O(n^2) time via one cumulative-cone numpy row per start index j;
    O(n) memory.  Segments are endpoint-defined (Sec. 3.1 design choice).
    Rows terminate early once the cone is permanently empty.
    """
    xs = np.asarray(xs, dtype=np.float64)
    n = xs.shape[0]
    ys = np.arange(n, dtype=np.float64)
    INF32 = np.iinfo(np.int32).max
    # T[k] = min #segments covering xs[0..k-1]; T[0] = 0 sentinel.
    T = np.full(n + 1, INF32, dtype=np.int64)
    T[0] = 0
    parent = np.full(n, -1, dtype=np.int64)
    CHUNK = 2048
    for j in range(n):
        if T[j] == INF32:
            continue
        cost = T[j] + 1
        # singleton segment [j, j]
        if cost < T[j + 1]:
            T[j + 1] = cost
            parent[j] = j
        # extend the row in chunks; stop as soon as the cone dies
        sl_hi, sl_lo = _INF, 0.0
        pos = j + 1
        while pos < n:
            hi = min(n, pos + CHUNK)
            dx = xs[pos:hi] - xs[j]
            dy = ys[pos:hi] - ys[j]
            dup = dx == 0.0
            with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
                s = np.where(dup, _INF, dy / np.where(dup, 1.0, dx))
                hi_cand = np.where(dup, np.where(dy <= error, _INF, -_INF),
                                   (dy + error) / np.where(dup, 1.0, dx))
                lo_cand = np.where(dup, -_INF, (dy - error) / np.where(dup, 1.0, dx))
            # cone over *interior* points (exclusive of the endpoint k)
            hi_acc = np.minimum.accumulate(np.concatenate(([sl_hi], hi_cand))[:-1])
            lo_acc = np.maximum.accumulate(np.concatenate(([sl_lo], lo_cand))[:-1])
            feasible = np.where(dup, dy <= error, (lo_acc <= s) & (s <= hi_acc))
            alive = hi_acc >= lo_acc  # monotone non-increasing
            feasible &= alive
            ks = np.nonzero(feasible)[0]
            if ks.size:
                tgt = pos + ks + 1  # T index for covering keys up to pos+ks
                upd = cost < T[tgt]
                T[tgt[upd]] = cost
                parent[pos + ks[upd]] = j
            if not alive[-1] or (min(float(np.min(hi_cand)), sl_hi)
                                 < max(float(np.max(lo_cand)), sl_lo)):
                break
            sl_hi = min(sl_hi, float(np.min(hi_cand)))
            sl_lo = max(sl_lo, float(np.max(lo_cand)))
            pos = hi
    n_opt = int(T[n])
    if not return_segments:
        return n_opt
    # reconstruct boundaries
    bounds = []
    k = n - 1
    while k >= 0:
        j = int(parent[k])
        bounds.append(j)
        k = j - 1
    return _finalize(xs, np.array(sorted(bounds)), error)


def verify_segments(xs: np.ndarray, segs: Segments) -> float:
    """Max |pred_pos - true_pos| over every element (Eq. 1). Must be <= segs.error.

    Each element is evaluated against its *containing* segment (the paper's
    per-segment guarantee).  With duplicate keys spanning a segment boundary a
    key-based assignment would be ambiguous, but lookups remain correct: the
    rightmost segment whose start <= k always contains an occurrence of k.
    """
    xs = np.asarray(xs, np.float64)
    n = xs.shape[0]
    true = np.arange(n, dtype=np.float64)
    sid = np.searchsorted(segs.base, true, side="right") - 1
    pred = segs.base[sid] + (xs - segs.start_key[sid]) * segs.slope[sid]
    return float(np.max(np.abs(pred - true)))


def max_segments_bound(n_keys: int, n_elems: int, error: int) -> float:
    """Sec. 3.4 guarantee: #segments <= min(|keys|/2, |D|/(error+1))."""
    return min(n_keys / 2.0, n_elems / (error + 1.0)) + 1.0
