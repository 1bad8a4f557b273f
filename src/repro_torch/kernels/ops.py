"""Thin compatibility layer over the ``cuda`` backend (port of
``repro.kernels.ops``).

``fitting_lookup``: the fused CUDA kernel (router + interpolation + window
clamp + window search + duplicate snap, one launch) through
``repro_torch.index.engine.kernel_lookup``.  The reference's TPU knobs
(``qcap``, ``interpret``, ``fallback``) have no counterpart: the Hopper
kernel has no buckets that could overflow, and nothing falls back.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.index.engine import (DeviceIndex, LookupPlan, kernel_lookup,
                                      make_plan)

__all__ = ["LookupPlan", "make_plan", "fitting_lookup", "make_lookup_fn"]


def make_lookup_fn(idx: DeviceIndex):
    """Lookup closure over a fixed index (the serving path)."""
    return functools.partial(fitting_lookup, idx)


def fitting_lookup(idx: DeviceIndex, queries: torch.Tensor) -> torch.Tensor:
    """Batched point lookup via the fused kernel: ranks, -1 where absent."""
    return kernel_lookup(idx, queries)
