"""Peaks of the cards the benchmark runs on, and the bytes the fused search's
work needs.

Peaks are NVIDIA's data-sheet figures for the H100 SXM at its 700 W limit
(dense, without sparsity); a card set below that limit runs slower, so every
share is printed beside the card's power limit.

The fused search (``fitting_search_kernel``) answers a batch of queries over
one key column.  Its bound is the least time the bytes of the work take at
the card's memory bandwidth, counted from the inputs alone, so every
implementation is held to the same count:

* each query read once (4 B, float32) and each rank written once (4 B);
* the segment table read once (start key, slope, base, end: 16 B a segment);
* each distinct column key that the error windows touch read once (4 B).

A query's window is the ``2 e + 2`` keys from ``rank - e``, where ``rank``
is its true insertion rank in the column: FITing-Tree's error bound puts the
true rank within ``e`` of the prediction, so this is the window any
implementation that honours the bound has to read, whatever it predicts.
"""
from __future__ import annotations

import numpy as np

# name as torch.cuda.get_device_name() gives it -> peaks
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops_per_s": 67e12,
                              "bf16_flops_per_s": 989e12},
}

QUERY_BYTES = 4
RANK_BYTES = 4
SEGMENT_BYTES = 16
KEY_BYTES = 4


def window_starts(true_ranks, error: int, n: int):
    """Start of each query's window, clipped into the column (numpy or torch
    int64 tensors alike)."""
    w = 2 * error + 2
    lo = true_ranks - error
    hi_start = max(n - w, 0)
    if isinstance(lo, np.ndarray):
        return np.clip(lo, 0, hi_start)
    return lo.clamp(0, hi_start)


def covered_keys(starts, window: int, n: int) -> int:
    """Distinct column indices the windows [start, start + window) touch."""
    if isinstance(starts, np.ndarray):
        s = np.sort(starts.astype(np.int64))
        ends = np.minimum(s + window, n)
        nxt = np.concatenate([s[1:], ends[-1:]])
        return int(np.clip(np.minimum(ends, nxt) - s, 0, None).sum())
    import torch
    s = torch.sort(starts.to(torch.int64)).values
    ends = (s + window).clamp(max=n)
    nxt = torch.cat([s[1:], ends[-1:]])
    return int((torch.minimum(ends, nxt) - s).clamp(min=0).sum())


def search_bytes(column, queries, error: int, n_segments: int,
                 device=None) -> int:
    """Bytes one fused-search call over ``column`` (sorted keys) for
    ``queries`` needs.  With ``device`` (a torch device) the ranks are
    found there, which is faster for large columns."""
    n = int(column.shape[0])
    q = int(np.size(queries))
    if n == 0 or q == 0:
        return 0
    window = 2 * error + 2
    if device is None:
        starts = window_starts(np.searchsorted(column, queries, "left"),
                               error, n)
    else:
        import torch
        col = column if isinstance(column, torch.Tensor) else \
            torch.as_tensor(column, device=device)
        qt = torch.as_tensor(np.asarray(queries, np.float64), device=device)
        starts = window_starts(torch.searchsorted(col, qt), error, n)
    covered = covered_keys(starts, window, n)
    return (KEY_BYTES * covered + SEGMENT_BYTES * int(n_segments)
            + q * (QUERY_BYTES + RANK_BYTES))
