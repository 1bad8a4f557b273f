"""The device form of a segment table and the per-query math every device
path shares: ``DeviceIndex``, ``predict_positions`` (route + interpolate +
clamp) and the duplicate snaps ``snap_leftmost`` / ``snap_side``.

It imports torch and nothing else of the package, so both the engine
(``index/engine.py``) and the kernels' plain twins
(``kernels/fitting_lookup.py``) build on it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DeviceIndex(NamedTuple):
    """f32/i32 device form of a SegmentTable, resident on one torch device."""
    seg_start: torch.Tensor  # (S,) f32  first key of each segment
    slope: torch.Tensor      # (S,) f32
    base: torch.Tensor       # (S,) i32  global position of segment start
    seg_end: torch.Tensor    # (S,) i32  one past the segment end
    keys: torch.Tensor       # (N,) f32  the sorted key column
    error: int


def _snap(keys: torch.Tensor, queries: torch.Tensor, rank: torch.Tensor,
          need: torch.Tensor, side: str) -> torch.Tensor:
    """Replace ``rank`` by the full-column searchsorted rank where ``need``
    is set.  The ``nonzero`` is the batch's one host sync; the search runs
    over the flagged queries only."""
    hits = need.nonzero().squeeze(1)
    if hits.numel() == 0:
        return rank
    fixed = torch.searchsorted(keys, queries[hits], side=side, out_int32=True)
    return rank.index_put((hits,), fixed.to(rank.dtype))


def snap_leftmost(keys: torch.Tensor, queries: torch.Tensor,
                  rank: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """Snap duplicate hits to the leftmost occurrence (mirror of the
    ``numpy_lookup`` fix): when a found rank's left neighbour still equals
    the query, the duplicate run straddles a segment boundary and the window
    search returned an in-segment rank.  A miss may carry a rank past the
    column (a window wider than it counts the clamped last key again), so
    the neighbour's index is clamped at both ends, as a JAX gather does."""
    n = keys.shape[0]
    need = hit & (rank > 0) & (keys[(rank - 1).clamp(0, n - 1)] == queries)
    return _snap(keys, queries, rank, need, "left")


def snap_side(keys: torch.Tensor, queries: torch.Tensor, rank: torch.Tensor,
              side: str) -> torch.Tensor:
    """Side-generalized duplicate snap for insertion-rank searches: a bounded
    window parks inside a duplicate run that extends past it, which shows at
    the landing position alone -- for ``side="left"`` the left neighbour
    still equals the query, for ``side="right"`` the landing key itself."""
    n = keys.shape[0]
    if side == "left":
        need = (rank > 0) & (keys[(rank - 1).clamp(min=0)] == queries)
    else:
        need = (rank < n) & (keys[rank.clamp(max=n - 1)] == queries)
    return _snap(keys, queries, rank, need, side)


def predict_positions(idx: DeviceIndex, queries: torch.Tensor) -> torch.Tensor:
    """Interpolated (approximate) global positions; error <= idx.error by Eq. 1.

    Route, interpolate in f32 (``torch.round`` rounds half to even, like
    ``jnp.round``), clamp into the owning segment's position range so gap
    queries cannot overshoot.  The rounded offset saturates at the int32
    range and is added in int64, so a far out-of-domain query clamps to its
    segment's end instead of wrapping."""
    sid = torch.searchsorted(idx.seg_start, queries, right=True) - 1
    sid = sid.clamp(0, idx.seg_start.shape[0] - 1)
    local = (queries - idx.seg_start[sid]) * idx.slope[sid]
    local = torch.nan_to_num(torch.round(local), nan=0.0).clamp(-2.0 ** 31,
                                                                2.0 ** 31)
    base = idx.base[sid]
    pred = base.to(torch.int64) + local.to(torch.int64)
    return torch.minimum(torch.maximum(pred, base), idx.seg_end[sid]).to(
        torch.int32)
