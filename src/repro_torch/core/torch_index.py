"""Device-side (torch) FITing-Tree: thin compatibility wrapper.

Counterpart of ``repro.core.jax_index``.  The canonical implementation lives
in ``repro_torch.index``: the segment geometry is a ``SegmentTable`` and the
batched bounded searches exist once, in ``repro_torch.index.engine``.  This
module keeps the reference's public surface (``DeviceIndex``,
``build_device_index``, ``lookup``, ``predict_positions``) plus the rank
primitives built on it (``bound``, ``range_count``).

Two bounded-search strategies (both O(error) bounded):
  * ``window``  -- gather the 2e+2 window and compare-reduce (what the
                   reference's TPU kernel does);
  * ``bisect``  -- log2(2e+2) halving steps of single gathers.

float32 keys: interpolation subtracts the segment start *before* rounding, so
provided per-segment key spans stay < 2^24 the f32 math is exact for integer
keys; ``rescale_keys`` maps arbitrary float64 keys into a safe range.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from repro_torch.index.engine import (DeviceIndex, device_index,
                                      predict_positions, torch_lookup,
                                      torch_search)
from repro_torch.index.table import SegmentTable

from .segmentation import Segments

__all__ = ["DeviceIndex", "build_device_index", "rescale_keys",
           "predict_positions", "lookup", "bound", "range_count"]


def build_device_index(keys: np.ndarray, error: int,
                       segs: Segments | None = None, *,
                       device=None) -> DeviceIndex:
    """Segment (if needed) and convert to the f32 device form on ``device``
    (``None``: the CUDA card)."""
    table = SegmentTable.from_keys(np.asarray(keys), error, segs=segs,
                                   assume_sorted=True)
    return device_index(table, device)


def rescale_keys(keys: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Affine-map keys into [0, 2^23] so f32 interpolation stays exact-ish."""
    lo, hi = float(keys[0]), float(keys[-1])
    scale = (2.0 ** 23) / max(hi - lo, 1.0)
    return (keys - lo) * scale, lo, scale


def lookup(idx: DeviceIndex, queries: torch.Tensor,
           strategy: Literal["window", "bisect"] = "window") -> torch.Tensor:
    """Batched point lookup.  Returns the rank (global position) of each query
    in ``idx.keys`` or -1 if absent."""
    return torch_lookup(idx, queries, strategy)


def bound(idx: DeviceIndex, q: torch.Tensor,
          side: Literal["left", "right"] = "left") -> torch.Tensor:
    """Batched lower/upper bound rank: the query plane's device primitive
    (bounded bisect + duplicate snap), equal to ``torch.searchsorted``."""
    return torch_search(idx, q, side, "bisect")


def range_count(idx: DeviceIndex, lo_q: torch.Tensor,
                hi_q: torch.Tensor) -> torch.Tensor:
    """Batched range-count: #keys in the inclusive [lo_q, hi_q] (duplicates
    included); inverted ranges count 0 instead of going negative."""
    return (torch_search(idx, hi_q, "right")
            - torch_search(idx, lo_q, "left")).clamp(min=0)
