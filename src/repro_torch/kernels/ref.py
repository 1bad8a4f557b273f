"""Plain torch oracle for the lookup kernel (port of ``repro.kernels.ref``).

Deliberately *independent* of the index machinery: ranks come from a full
searchsorted over the key column, so any interpolation or window bug in the
kernel path shows up as a mismatch.
"""
from __future__ import annotations

import torch


def lookup_ref(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Global rank of each query in the sorted ``keys``, or -1 if absent."""
    rank = torch.searchsorted(keys, queries, side="left")
    n = keys.shape[0]
    hit = (rank < n) & (keys[rank.clamp(max=n - 1)] == queries)
    return torch.where(hit, rank, -1).to(torch.int32)
