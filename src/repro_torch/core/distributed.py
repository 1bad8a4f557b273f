"""Range-partitioned FITing-Tree across torch devices: compatibility wrapper
(port of ``repro.core.distributed``).

The canonical implementation lives in ``repro_torch.index.device_plane``:
the sharded searches exist once (``sharded_lookup_allgather`` /
``sharded_lookup_a2a``, plus the two-sided ``sharded_search_*`` rank
primitives they derive from), and the *served* plane -- delta epoch
publish, the versioned ``DeviceShardSet`` manifest, a2a overflow
resolution, telemetry -- is ``DeviceShardedService``.  This module keeps the
seed-era public surface (``ShardedIndex``, ``build_sharded_index``,
``lookup_allgather``, ``lookup_a2a``) as thin wrappers over those searches.

Where the reference takes ``mesh, axis``, the port takes ``devices``: one
torch device per shard row (``["cpu"] * 8`` on the CPU, ``["cuda:0"] * 4``
on one card).  Row d of every field lives on ``devices[d]``; queries and
answers live on ``devices[0]``.

Semantics are unchanged for the seed layout (equal-count shards, unique
keys): global rank of each query, -1 if absent.  ``lookup_a2a`` returns the
legacy ``(ranks, ok)`` pair where ``ok=False`` marks queries dropped by
bucket overflow under skew -- callers re-ask via ``lookup_allgather``, or
use ``DeviceShardedService``, which performs that follow-up pass itself.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.index.device_plane import (sharded_lookup_a2a,
                                            sharded_lookup_allgather)
from repro_torch.index.sharded import pack_shard_tables
from repro_torch.index.table import build_shard_tables


class ShardedIndex(NamedTuple):
    seg_start: tuple[torch.Tensor, ...]   # D x (S_max,) f32, +inf padded
    slope: tuple[torch.Tensor, ...]       # D x (S_max,) f32
    base: tuple[torch.Tensor, ...]        # D x (S_max,) i32
    seg_end: tuple[torch.Tensor, ...]     # D x (S_max,) i32
    keys: tuple[torch.Tensor, ...]        # D x (M,) f32 -- equal-count shards
    boundaries: tuple[torch.Tensor, ...]  # D x (D,) f32 replicated router
    n_segments: tuple[int, ...]           # live segments per row
    error: int


def build_sharded_index(keys: np.ndarray, error: int, n_shards: int, *,
                        devices: Sequence) -> ShardedIndex:
    """Equal-count shards (the tail beyond ``n_shards * (n // n_shards)`` is
    the caller's), one canonical ``SegmentTable`` per shard, padded by the
    shared ``pack_shard_tables`` bridge; row d placed on ``devices[d]``."""
    if len(devices) != n_shards:
        raise ValueError(f"need one device per shard: {len(devices)} "
                         f"devices for {n_shards} shards")
    keys = np.asarray(keys, np.float64)
    m = keys.shape[0] // n_shards
    tables = build_shard_tables(keys, error, n_shards)
    shards = keys[: m * n_shards].reshape(n_shards, m).astype(np.float32)
    packed = pack_shard_tables(tables)

    def rows(arr, dtype):
        return tuple(torch.tensor(np.asarray(arr[d], dtype), device=dev)
                     for d, dev in enumerate(devices))

    bounds = np.asarray(packed.boundaries, np.float32)
    return ShardedIndex(
        seg_start=rows(packed.seg_start, np.float32),
        slope=rows(packed.slope, np.float32),
        base=rows(packed.base, np.int32),
        seg_end=rows(packed.seg_end, np.int32),
        keys=rows(shards, np.float32),
        boundaries=tuple(torch.tensor(bounds, device=dev)
                         for dev in devices),
        n_segments=tuple(int(t.n_segments) for t in tables),
        error=int(error))


def _seed_layout(si: ShardedIndex, devices: Sequence):
    """The seed layout's implied row metadata: equal-count shards (every row
    fully live) and the prefix offsets ``arange(d) * m``, one copy per row's
    device."""
    d = len(devices)
    m = int(si.keys[0].shape[0])
    offsets = np.arange(d, dtype=np.int32) * m
    return (m,) * d, tuple(torch.tensor(offsets, device=dev)
                           for dev in devices)


def _queries(queries, devices: Sequence) -> torch.Tensor:
    if isinstance(queries, torch.Tensor):
        return queries.to(devices[0], torch.float32).reshape(-1)
    return torch.from_numpy(np.array(queries, np.float32).ravel()).to(
        devices[0])


def lookup_allgather(si: ShardedIndex, queries, devices: Sequence
                     ) -> torch.Tensor:
    """Every shard answers the full query set; the answers are summed.

    Deprecated entry point: delegates to
    :func:`repro_torch.index.device_plane.sharded_lookup_allgather` (use
    ``DeviceShardedService`` for the served plane)."""
    n_local, _ = _seed_layout(si, devices)
    return sharded_lookup_allgather(
        si.seg_start, si.slope, si.base, si.seg_end, si.keys, n_local,
        _queries(queries, devices), devices=devices, error=si.error,
        n_segments=si.n_segments)


def lookup_a2a(si: ShardedIndex, queries, devices: Sequence,
               slack: float = 2.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed all_to_all exchange; returns the legacy ``(ranks, ok)`` pair.

    Deprecated entry point: delegates to
    :func:`repro_torch.index.device_plane.sharded_lookup_a2a`.  ``ok=False``
    marks queries dropped by bucket overflow under skew beyond ``slack`` --
    the caller may re-ask those via :func:`lookup_allgather`;
    ``DeviceShardedService`` performs that follow-up pass itself, so the
    mask never reaches *its* callers."""
    n_local, offsets = _seed_layout(si, devices)
    return sharded_lookup_a2a(
        si.seg_start, si.slope, si.base, si.seg_end, si.keys, n_local,
        offsets, si.boundaries, _queries(queries, devices), devices=devices,
        error=si.error, slack=slack, n_segments=si.n_segments)
