"""Device-sharded serving plane: replicated router, one shard row per
device, delta epoch publish (port of ``repro.index.device``).

The paper's recursive structure -- a tiny top-level router over per-partition
linear segments -- maps onto a list of torch devices, one per shard row: the
shard-boundary router is *replicated* (every row's device holds the (D,) cut
column), each row owns one shard's padded segment table and sorted key
column, and the two-sided bounded-window ``search`` primitive fans out over
the rows with one of two exchange strategies:

* ``"allgather"`` -- every row receives the full query batch, answers it
  against its local shard, and the per-row insertion ranks are summed on the
  first row's device: over contiguous sorted shard runs,
  ``searchsorted(all_keys, q) == sum_d searchsorted(shard_d, q)``.  No
  ownership masks, duplicate-safe by construction.
* ``"a2a"`` -- queries are bucketed to their *owning* row by the replicated
  router (duplicate-safe serving cuts guarantee owner-local rank + prefix
  offset == global rank), each row receives its buckets from every source
  chunk under a slack-capacity factor, answers them, and sends the answers
  back.  Bucket overflow beyond slack is **resolved inside the service** by
  a follow-up allgather pass over just the overflowed queries -- the
  dropped-query mask never leaks to callers.

The layout is single-controller, as the reference's ``shard_map`` over a
``Mesh`` is: one process drives every row, and the collectives are tensor
moves between devices inside that process (allgather: ``q.to(dev_d)`` for
every row; psum: the rows' ranks summed after ``.to(home)``; all_to_all:
row j's buckets from every source, ``.to(dev_j)``, and back).  The same code
serves eight rows on the CPU (``devices=["cpu"] * 8``, the counterpart of
``--xla_force_host_platform_device_count=8``), four rows on one card
(``devices=["cuda:0"] * 4``), or one row per card (``cuda:0..D-1``, where
the moves are peer copies; torch orders a copy between two cards on both
cards' current streams).  Each verb ends in one host sync, the copy of its
ranks to the host.

``DeviceShardedService`` wraps the ``ShardedIndexService`` write path
(insert routing, Alg. 4 buffers, per-shard epoch publish, rebalance) and
installs snapshots onto the rows as an immutable versioned
:class:`DeviceShardSet` -- the same single-reference-swap / pinned-reader
discipline as ``ShardSet`` and the LSM ``LevelSet``.  Publishes are **delta
uploads**: the manifest keeps per-shard epoch fingerprints, and a publish
that dirtied one shard re-uploads only that shard's padded row; the clean
rows keep their tensors (same storage, checked by ``data_ptr()``).  Rows are
padded to capacity (``s_cap``/``m_cap``, headroom over the current maxima)
so steady-state publishes stay delta-eligible; cap overflow or a boundary
change (rebalance / structural replan) falls back to a full re-pack with
fresh headroom.

All five query verbs stay bit-identical to the numpy oracle under the f32
key contract (exact for f32-representable keys, e.g. integers < 2^24).

Two departures from the reference, by name:

* **Layout.**  The reference's ``index/device.py`` holds this plane; in the
  port that module name has held ``DeviceIndex``, ``predict_positions`` and
  the duplicate snaps since the fused search kernel, so the plane lives here
  and ``repro_torch.index`` re-exports it under the reference's names.
* **The per-row search runs the hand-written kernel.**  The reference
  searches each +inf-padded row with ``xla_search(..., "bisect")``; here
  each row is one ``kernel_search`` (one launch of the fused search kernel,
  ``kernels/fitting_lookup.py`` ``fitting_search_cuda``, on a CUDA row; its
  plain twin on a CPU row) over views of the row's live prefix
  (``keys[:n_local]`` and the first ``n_segments`` of each segment field).
  Both give the ``np.searchsorted`` rank, so the ranks are the same
  integers.  Rows with no keys are skipped and count 0, as the reference's
  ``where(n_loc > 0, r, 0)`` does.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from repro_torch.analysis import sanitizer
from repro_torch.core.cost_model import choose_exchange
from repro_torch.index.table import route_keys

from .device import DeviceIndex
from .engine import kernel_search
from .query import PointResult, RangeResult, check_range, check_side
from .sharded import ShardedIndexService
from .snapshot import Snapshot
from .telemetry import (CH_DEVICE_COLLECTIVE, CH_DEVICE_OVERFLOW,
                        CH_DEVICE_PUBLISH, XCHG_A2A, XCHG_ALLGATHER,
                        DeviceMetrics, Monitor)

if TYPE_CHECKING:   # runtime import is lazy (fit builds services via plans)
    from .fit import IndexPlan

_EXCHANGES = ("allgather", "a2a", "auto")
_ROW_FIELDS = ("d_seg_start", "d_slope", "d_base", "d_seg_end", "d_keys")


# ------------------------------------------------------------- the row search
def _row_search(seg_start: torch.Tensor, slope: torch.Tensor,
                base: torch.Tensor, seg_end: torch.Tensor, keys: torch.Tensor,
                n_local: int, n_segments: int, q: torch.Tensor, *,
                error: int, side: str) -> torch.Tensor:
    """One row's local insertion ranks (int32, on the row's device): the
    fused search kernel over views of the row's live prefix; 0 for an empty
    row (the kernel needs n >= 1)."""
    if n_local == 0:
        return torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    s = n_segments
    idx = DeviceIndex(seg_start[:s], slope[:s], base[:s], seg_end[:s],
                      keys[:n_local], error)
    return kernel_search(idx, q, side)


def _rows(devices, *fields) -> int:
    d = len(devices)
    if d < 1 or any(len(f) != d for f in fields):
        raise ValueError(f"need one row per device: {d} devices, rows "
                         f"{[len(f) for f in fields]}")
    return d


# ------------------------------------------------------- the sharded kernels
def sharded_search_allgather(seg_start, slope, base, seg_end, keys, n_local,
                             queries: torch.Tensor, *,
                             devices: Sequence, error: int,
                             n_segments: Sequence[int],
                             side: str = "left") -> torch.Tensor:
    """Global insertion ranks as the sum of per-row local ranks.

    ``seg_start`` .. ``keys`` are sequences of D 1-D tensors, row d on
    ``devices[d]`` (padded as :func:`_pack_row` pads); ``n_local`` and
    ``n_segments`` are the rows' live key and segment counts.  Every row
    receives the whole batch, searches it, and the ranks are summed on
    ``devices[0]``, where ``queries`` lives: shard runs are contiguous in
    key order, so the sum *is* the global ``searchsorted`` rank --
    duplicate runs straddling a shard cut included.  Returns int32 ranks on
    ``devices[0]``."""
    check_side(side)
    d = _rows(devices, seg_start, slope, base, seg_end, keys, n_local,
              n_segments)
    home = torch.device(devices[0])
    total = torch.zeros(queries.shape[0], dtype=torch.int32, device=home)
    for r in range(d):
        q = queries.to(devices[r])
        local = _row_search(seg_start[r], slope[r], base[r], seg_end[r],
                            keys[r], int(n_local[r]), int(n_segments[r]), q,
                            error=error, side=side)
        total += local.to(home)
    return total


def _bucket(queries: torch.Tensor, boundaries: torch.Tensor, d: int,
            cap: int):
    """Slot each source chunk's queries into D owner buckets of ``cap``.

    Returns ``buckets`` (owner, source, cap) f32 with +inf sentinels and
    ``src_pos`` (owner, source, cap) i64 with -1 sentinels.  A query keeps
    its slot where the reference's scatter leaves it: ranks past ``cap - 1``
    clip onto the last slot and are written after it in sorted order, so a
    bucket that overflows loses its last slot to a sentinel too."""
    q_per = queries.shape[0] // d
    q = queries.view(d, q_per)
    owner = (torch.searchsorted(boundaries, q, right=True) - 1).clamp(0, d - 1)
    order = torch.argsort(owner, dim=1, stable=True)
    sorted_owner = torch.gather(owner, 1, order)
    first = torch.searchsorted(sorted_owner, sorted_owner, side="left")
    count = torch.searchsorted(sorted_owner, sorted_owner,
                               side="right") - first
    rank = torch.arange(q_per, device=q.device) - first
    kept = (rank < cap - 1) | ((rank == cap - 1) & (count <= cap))
    source = torch.arange(d, device=q.device)[:, None].expand(d, q_per)
    slot = torch.where(kept, rank, cap)        # slot ``cap``: the discard
    buckets = torch.full((d, d, cap + 1), float("inf"), dtype=q.dtype,
                         device=q.device)
    src_pos = torch.full((d, d, cap + 1), -1, dtype=torch.int64,
                         device=q.device)
    buckets.index_put_((sorted_owner, source, slot), torch.gather(q, 1, order))
    src_pos.index_put_((sorted_owner, source, slot), order)
    return buckets[..., :cap].contiguous(), src_pos[..., :cap]


def sharded_search_a2a(seg_start, slope, base, seg_end, keys, n_local,
                       offsets, boundaries, queries: torch.Tensor, *,
                       devices: Sequence, error: int,
                       n_segments: Sequence[int], side: str = "left",
                       slack: float = 2.0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Owner-bucketed all_to_all insertion-rank search.

    ``queries`` (on ``devices[0]``, a multiple of D long) is D source chunks
    of ``Q/D``, chunk s standing for device s's share.  Each chunk routes its
    queries through the replicated boundary router (``boundaries[0]``) and
    slots them into D buckets of capacity ``ceil(Q/D^2 * slack)``; row j
    receives its bucket from every chunk, answers the queries it owns (local
    rank + its replicated prefix ``offsets[j][j]`` == global rank, because
    serving cuts are duplicate-safe), and the answers return to their
    chunks.  Returns ``(ranks, ok)`` on ``devices[0]``, where ``ok=False``
    marks queries dropped by bucket overflow under skew --
    ``DeviceShardedService`` resolves those with a follow-up allgather pass
    so callers never see the mask."""
    check_side(side)
    d = _rows(devices, seg_start, slope, base, seg_end, keys, n_local,
              n_segments, offsets, boundaries)
    if queries.shape[0] % d:
        raise ValueError(f"the a2a batch must be a multiple of the {d} rows, "
                         f"got {queries.shape[0]}")
    home = torch.device(devices[0])
    q_per = queries.shape[0] // d
    cap = max(1, int(np.ceil(q_per / d * slack)))
    buckets, src_pos = _bucket(queries, boundaries[0], d, cap)
    back = []
    for j in range(d):
        incoming = buckets[j].view(-1).to(devices[j])   # (source, cap) flat
        r = _row_search(seg_start[j], slope[j], base[j], seg_end[j], keys[j],
                        int(n_local[j]), int(n_segments[j]), incoming,
                        error=error,
                        side=side)
        back.append((r + offsets[j][j]).to(home))
    # (owner, source, cap) -> per source chunk, scattered back to the query
    # slots with a max (sentinel slots carry src_pos -1 and add 0: ranks >= 0)
    back = torch.stack(back).view(d, d, cap).transpose(0, 1).reshape(d, -1)
    src = src_pos.transpose(0, 1).reshape(d, -1)
    good = src >= 0
    at = src.clamp(min=0)
    ranks = torch.zeros(d, q_per, dtype=torch.int32, device=home)
    ranks = ranks.scatter_reduce(1, at, torch.where(good, back, 0), "amax")
    ok = torch.zeros(d, q_per, dtype=torch.int32, device=home)
    ok = ok.scatter_reduce(1, at, good.to(torch.int32), "amax")
    return ranks.view(-1), ok.view(-1) > 0


def sharded_lookup_allgather(seg_start, slope, base, seg_end, keys, n_local,
                             queries: torch.Tensor, *, devices: Sequence,
                             error: int, n_segments: Sequence[int]
                             ) -> torch.Tensor:
    """Point semantics over the allgather search: leftmost rank where the
    key is present (``right > left``), -1 where absent; the target of
    ``repro_torch.core.distributed``."""
    args = (seg_start, slope, base, seg_end, keys, n_local, queries)
    kw = dict(devices=devices, error=error, n_segments=n_segments)
    left = sharded_search_allgather(*args, side="left", **kw)
    right = sharded_search_allgather(*args, side="right", **kw)
    return torch.where(right > left, left, -1)


def sharded_lookup_a2a(seg_start, slope, base, seg_end, keys, n_local,
                       offsets, boundaries, queries: torch.Tensor, *,
                       devices: Sequence, error: int,
                       n_segments: Sequence[int], slack: float = 2.0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Point semantics over the a2a search; returns ``(ranks, ok)`` with
    ``ok=False`` marking bucket-overflow drops (the legacy ``lookup_a2a``
    contract -- the service path resolves the mask itself)."""
    args = (seg_start, slope, base, seg_end, keys, n_local, offsets,
            boundaries, queries)
    kw = dict(devices=devices, error=error, slack=slack,
              n_segments=n_segments)
    left, ok_l = sharded_search_a2a(*args, side="left", **kw)
    right, ok_r = sharded_search_a2a(*args, side="right", **kw)
    return torch.where(right > left, left, -1), ok_l & ok_r


# ------------------------------------------------------------- the manifest
@dataclasses.dataclass(frozen=True)
class DeviceShardSet:
    """One immutable, versioned device-resident serving view.

    Published with a single reference assignment
    (``service._device_set = DeviceShardSet(...)``) and pinned once per
    verb, exactly the ``ShardSet`` discipline: a reader resolves routing,
    device rows, rank offsets and host-side materialization against this
    one object, so a concurrent (delta) publish can never tear a batch.

    ``snapshots`` pins the host epoch each row was packed from -- the
    per-shard dirtiness fingerprint for delta publish (a host publish always
    installs a *new* ``Snapshot`` object) and the materialization source for
    ``range``.  ``s_cap``/``m_cap`` are the padded row capacities.  Each
    ``d_*`` row field is a tuple of D tensors, row d on the row's device, so
    a delta publish replaces the dirty rows' tensors and keeps the clean
    rows' storage; ``d_offsets``/``d_boundaries`` hold one replicated copy
    per row's device; ``n_local``/``n_seg_local`` are the rows' live key and
    segment counts (host ints: the live-prefix views need no device read)."""
    version: int
    host_version: int                   # ShardSet.version this was built from
    error: int
    n_keys: int                         # total keys served
    n_segments: int                     # total segments across shards
    s_cap: int                          # padded segment columns per row
    m_cap: int                          # padded key columns per row
    boundaries: np.ndarray              # (D,) f64 router cuts (host copy)
    offsets: np.ndarray                 # (D,) i64 global-rank prefix offsets
    snapshots: tuple[Snapshot, ...]     # pinned host snapshots, one per shard
    epochs: tuple[int, ...]             # per-shard epoch fingerprints
    n_local: tuple[int, ...]            # live keys per row
    n_seg_local: tuple[int, ...]        # live segments per row
    d_seg_start: tuple[torch.Tensor, ...]   # D x (s_cap,) f32, +inf padded
    d_slope: tuple[torch.Tensor, ...]       # D x (s_cap,) f32
    d_base: tuple[torch.Tensor, ...]        # D x (s_cap,) i32
    d_seg_end: tuple[torch.Tensor, ...]     # D x (s_cap,) i32
    d_keys: tuple[torch.Tensor, ...]        # D x (m_cap,) f32, +inf padded
    d_offsets: tuple[torch.Tensor, ...]     # D x (D,) i32 replicated offsets
    d_boundaries: tuple[torch.Tensor, ...]  # D x (D,) f32 replicated router

    def __post_init__(self):
        # published = immutable: freeze the host-side columns a pinned
        # reader routes/lifts with (the row tensors are never written)
        object.__setattr__(self, "boundaries",
                           sanitizer.published_array(self.boundaries))
        object.__setattr__(self, "offsets",
                           sanitizer.published_array(self.offsets))

    @property
    def n_devices(self) -> int:
        return len(self.snapshots)

    def row_bytes(self) -> int:
        """Device-resident bytes of ONE shard row (the reference's count:
        four segment fields, the key column and the live-key count)."""
        return int(4 * self.s_cap * 4 + self.m_cap * 4 + 4)

    def replicated_bytes(self) -> int:
        """Bytes of the replicated router + offsets on ONE device."""
        return int(self.n_devices * (4 + 4))


def _pack_row(table, s_cap: int, m_cap: int):
    """One shard's padded device row: +inf start-key / key padding, 0 slope,
    n_keys base/seg_end (an empty trailing window) -- the
    ``pack_shard_tables`` scheme widened to capacity, in device dtypes."""
    s, n = table.n_segments, table.n_keys
    seg_start = np.full(s_cap, np.inf, np.float32)
    slope = np.zeros(s_cap, np.float32)
    base = np.full(s_cap, n, np.int32)
    seg_end = np.full(s_cap, n, np.int32)
    seg_start[:s] = table.start_key
    slope[:s] = table.slope
    base[:s] = table.base
    seg_end[:s] = table.seg_end
    keys = np.full(m_cap, np.inf, np.float32)
    keys[:n] = table.keys
    return seg_start, slope, base, seg_end, keys, n


def _put(arr: np.ndarray, device) -> torch.Tensor:
    """A fresh tensor on ``device`` holding a copy of ``arr``."""
    return torch.tensor(arr, device=device)


def _resolve_devices(devices, d: int) -> list[torch.device]:
    """The row devices: ``devices`` as given (one per row), or ``None`` for
    ``cuda:0 .. cuda:D-1``, raising where fewer cards exist."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < d:
            raise ValueError(
                f"device_count={d} exceeds the {have} available CUDA "
                f"devices; pass devices=[...] (one torch device per row) to "
                f"put several rows on one card (devices=['cuda:0'] * {d}) "
                f"or on the CPU (devices=['cpu'] * {d})")
        return [torch.device("cuda", i) for i in range(d)]
    out = [torch.device(x) for x in devices]
    if len(out) != d:
        raise ValueError(f"devices names {len(out)} rows for "
                         f"device_count={d}")
    for dev in out:
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the rows "
                               f"{[str(x) for x in out]}")
    return out


# ------------------------------------------------------------- the service
class DeviceShardedService:
    """``ShardedIndexService`` write path, device-resident read path.

    Construction partitions the keys into ``device_count`` contiguous
    shards (one host ``ShardedIndexService`` with the same cuts owns the
    writers/publishers) and uploads one padded row per shard onto its
    device.  From then on:

        svc = DeviceShardedService(keys, error=64, device_count=4,
                                   buffer_size=16)
        svc.insert(k)        # routed + buffered on the host writer (Alg. 4)
        svc.publish()        # host epoch cut, then a DELTA upload: only
                             # dirty shards' rows are re-uploaded
        svc.search(q)        # fan-out over the rows, global ranks
        svc.lookup(q)        # and the full typed verb surface

    ``exchange`` picks the strategy: ``"allgather"`` (robust, every row
    searches the whole batch), ``"a2a"`` (owner-routed, per-row work shrinks
    with D; slack overflow resolved internally via a follow-up allgather
    pass), or ``"auto"`` (per-batch cost-model crossover,
    :func:`repro_torch.core.cost_model.choose_exchange`).

    ``devices`` places the rows, one torch device each: ``None`` means
    ``cuda:0 .. cuda:D-1`` and raises where fewer cards exist (there is no
    fallback to the CPU); ``devices=["cuda:0"] * 4`` puts four rows on one
    card and ``devices=["cpu"] * 8`` eight on the CPU.  Needs at least
    ``device_count`` distinct keys.
    """

    def __init__(self, keys: np.ndarray, error: int | None = None, *,
                 plan: "IndexPlan | None" = None,
                 device_count: int | None = None,
                 buffer_size: int | None = None,
                 publish_every: int | None = None,
                 exchange: str | None = None,
                 payload: np.ndarray | None = None,
                 devices: Sequence | None = None,
                 slack: float = 2.0, headroom: float = 0.5,
                 skew_threshold: float = 2.0, pending_weight: float = 1.0,
                 mode: str = "paper", assume_sorted: bool = False,
                 monitor: Monitor | None = None):
        from .fit import IndexPlan

        raw = {"error": error, "device_count": device_count,
               "buffer_size": buffer_size, "publish_every": publish_every,
               "exchange": exchange}
        if plan is None:
            if error is None:
                raise TypeError("pass error=... (expert knobs) or plan=... "
                                "(an IndexPlan from repro_torch.index.fit)")
            if device_count is not None:
                d = int(device_count)
            elif devices is not None:
                d = len(devices)
            else:
                d = torch.cuda.device_count() if torch.cuda.is_available() \
                    else 0
            if d < 1:
                raise ValueError(f"device_count must be >= 1, got {d} (no "
                                 "CUDA device and no devices=[...])")
            plan = dataclasses.replace(
                IndexPlan.from_knobs(
                    error=error, n_shards=d,
                    buffer_size=0 if buffer_size is None else buffer_size,
                    backend="device", publish_every=publish_every),
                device_count=d,
                exchange="allgather" if exchange is None else exchange)
        else:
            clashing = sorted(k for k, v in raw.items() if v is not None)
            if clashing:
                raise TypeError("pass either the raw knobs or plan=, not "
                                f"both -- the plan already fixes "
                                f"{', '.join(clashing)}")
        if plan.backend != "device":
            raise ValueError(f"DeviceShardedService needs backend='device', "
                             f"plan has {plan.backend!r}")
        d = int(plan.device_count or plan.n_shards)
        if plan.exchange is not None and plan.exchange not in _EXCHANGES:
            raise ValueError(f"exchange must be one of {_EXCHANGES}, got "
                             f"{plan.exchange!r}")
        self._devices = _resolve_devices(devices, d)
        self.plan = plan
        self.exchange = plan.exchange or "allgather"
        self.publish_every = plan.publish_every
        self.monitor = monitor
        self.slack = float(slack)
        self.headroom = float(headroom)

        # the host write plane: same cuts, same writers, numpy verbs kept as
        # the bit-identity oracle.  Plain dataclasses.replace (not
        # plan.replace) so the host plan keeps the device plan's revision;
        # the device service runs the publish cadence itself.
        host_plan = dataclasses.replace(plan, backend="numpy", n_shards=d,
                                        publish_every=None, device_count=None,
                                        exchange=None)
        self._host = ShardedIndexService(
            keys, plan=host_plan, payload=payload, mode=mode,
            skew_threshold=skew_threshold, pending_weight=pending_weight,
            assume_sorted=assume_sorted, monitor=monitor)

        # ranks *before* the host service's write lock: device mutators wrap
        # the host ones (publish -> host.publish under both locks)
        self._write_lock = sanitizer.make_rlock(
            "DeviceShardedService._write_lock")
        self._counts_lock = sanitizer.make_lock(
            "DeviceShardedService._counts_lock")
        self._query_counts = {"points": 0, "ranges": 0, "counts": 0,
                              "predecessors": 0, "successors": 0,
                              "searches": 0}
        self._publishes = 0
        self._delta_publishes = 0
        self._full_publishes = 0
        self._bytes_uploaded = 0
        self._bytes_full_equivalent = 0
        self._xchg_counts = {"allgather": 0, "a2a": 0}
        self._overflow_queries = 0
        self._collective_wall_ns = 0.0
        ds0 = self._full_set(version=1)
        self._device_set = ds0
        self._account_publish(ds0, self._full_bytes(ds0), full=True,
                              dirty=d, wall_ns=0)

    @classmethod
    def from_plan(cls, keys: np.ndarray, plan: "IndexPlan", *,
                  payload: np.ndarray | None = None,
                  **service_kwargs) -> "DeviceShardedService":
        """Build from a resolved ``IndexPlan`` (the ``fit.open_index`` path
        for ``backend='device'``); ``service_kwargs`` may name ``devices``."""
        return cls(keys, plan=plan, payload=payload, **service_kwargs)

    # ------------------------------------------------------------------ shape
    @property
    def host(self) -> ShardedIndexService:
        """The wrapped host write plane (writers, publishers, rebalancer)."""
        return self._host

    @property
    def devices(self) -> list[torch.device]:
        """The rows' torch devices, one per shard."""
        return list(self._devices)

    @property
    def n_devices(self) -> int:
        return len(self._devices)

    @property
    def n_shards(self) -> int:
        return self._host.n_shards

    @property
    def device_set(self) -> DeviceShardSet:
        """The current immutable device manifest (pin it for consistency)."""
        return self._device_set

    @property
    def boundaries(self) -> np.ndarray:
        return self._host.boundaries

    @property
    def pending_inserts(self) -> int:
        return self._host.pending_inserts

    def shard_of(self, key: float) -> int:
        return self._host.shard_of(key)

    def epochs(self) -> list[int]:
        return self._host.epochs()

    def imbalance(self) -> float:
        return self._host.imbalance()

    def needs_rebalance(self) -> bool:
        return self._host.needs_rebalance()

    def _pin_device_set(self) -> DeviceShardSet:
        """THE read-path pin: one reference read of the live device manifest
        per verb (RI002); the pinned version is reported to the sanitizer's
        PinTracker, which asserts no verb mixes two manifests end-to-end."""
        ds = self._device_set
        sanitizer.observe_pin(ds.version)
        return ds

    def _count(self, shape: str, n: int) -> None:
        with self._counts_lock:
            self._query_counts[shape] += n

    # ------------------------------------------------------------ build/upload
    def _caps_for(self, snaps: Sequence[Snapshot]) -> tuple[int, int]:
        """Padded row capacities with headroom over the current maxima, so
        steady-state inserts re-publish into the same shapes (delta-eligible);
        the +8/+64 floors keep tiny shards delta-able too."""
        s_max = max(s.table.n_segments for s in snaps)
        m_max = max(s.n_keys for s in snaps)
        s_cap = int(np.ceil(max(s_max, 1) * (1.0 + self.headroom))) + 8
        m_cap = int(np.ceil(max(m_max, 1) * (1.0 + self.headroom))) + 64
        return s_cap, m_cap

    def _manifest(self, snaps, host_version: int, version: int, s_cap: int,
                  m_cap: int, rows: dict) -> DeviceShardSet:
        boundaries = np.asarray(self._host.boundaries, np.float64)
        sizes = np.asarray([s.n_keys for s in snaps], np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        offs32 = offsets.astype(np.int32)
        bounds32 = boundaries.astype(np.float32)
        return DeviceShardSet(
            version=version, host_version=host_version,
            error=int(self._host.error), n_keys=int(sizes.sum()),
            n_segments=int(sum(s.table.n_segments for s in snaps)),
            s_cap=s_cap, m_cap=m_cap, boundaries=boundaries, offsets=offsets,
            snapshots=tuple(snaps),
            epochs=tuple(s.epoch for s in snaps),
            n_local=tuple(int(s.n_keys) for s in snaps),
            n_seg_local=tuple(int(s.table.n_segments) for s in snaps),
            d_offsets=tuple(_put(offs32, dev) for dev in self._devices),
            d_boundaries=tuple(_put(bounds32, dev) for dev in self._devices),
            **rows)

    def _upload(self, table, s_cap: int, m_cap: int, dev) -> tuple:
        """Pack one shard's row and place its five tensors on ``dev``."""
        return tuple(_put(a, dev) for a in _pack_row(table, s_cap, m_cap)[:5])

    def _full_set(self, version: int) -> DeviceShardSet:
        """Pack every shard's snapshot and upload the whole layout (build,
        rebalance, structural replan, or capacity overflow)."""
        host_ss = self._host.shard_set
        snaps = [h.current() for h in host_ss.handles]
        s_cap, m_cap = self._caps_for(snaps)
        rows = [self._upload(s.table, s_cap, m_cap, dev)
                for s, dev in zip(snaps, self._devices)]
        return self._manifest(
            snaps, host_ss.version, version, s_cap, m_cap,
            {name: tuple(r[i] for r in rows)
             for i, name in enumerate(_ROW_FIELDS)})

    def _delta_set(self, cur: DeviceShardSet, snaps: list[Snapshot],
                   dirty: list[int]) -> DeviceShardSet:
        """Delta upload: re-pack ONLY the dirty shards' rows into the current
        capacities and swap them in; clean rows keep their tensors."""
        fresh = {d: self._upload(snaps[d].table, cur.s_cap, cur.m_cap,
                                 self._devices[d]) for d in dirty}
        rows = {}
        for i, name in enumerate(_ROW_FIELDS):
            old = getattr(cur, name)
            rows[name] = tuple(fresh[d][i] if d in fresh else old[d]
                               for d in range(len(old)))
        return self._manifest(snaps, cur.host_version, cur.version + 1,
                              cur.s_cap, cur.m_cap, rows)

    def _full_bytes(self, ds: DeviceShardSet) -> int:
        return ds.row_bytes() * ds.n_devices + \
            ds.replicated_bytes() * ds.n_devices

    def _account_publish(self, ds: DeviceShardSet, up_bytes: int, *,
                         full: bool, dirty: int, wall_ns: int) -> None:
        self._publishes += 1
        if full:
            self._full_publishes += 1
        else:
            self._delta_publishes += 1
        self._bytes_uploaded += up_bytes
        self._bytes_full_equivalent += self._full_bytes(ds)
        if self.monitor is not None:
            self.monitor.record(CH_DEVICE_PUBLISH, dirty, up_bytes, wall_ns,
                                1 if full else 0)

    def _sync_locked(self) -> None:
        """Reconcile the device manifest with the host serving state: delta
        upload when only snapshots moved and the new tables fit the current
        capacities; full re-pack on a boundary change (rebalance/replan),
        shard-count change, or capacity overflow.  Ends in the single
        reference assignment that publishes the new manifest."""
        t0 = time.perf_counter_ns()
        cur = self._device_set
        host_ss = self._host.shard_set
        snaps = [h.current() for h in host_ss.handles]
        structural = (host_ss.version != cur.host_version
                      or len(snaps) != len(cur.snapshots)
                      or max(s.table.n_segments for s in snaps) > cur.s_cap
                      or max(s.n_keys for s in snaps) > cur.m_cap)
        if structural:
            new = self._full_set(cur.version + 1)
            self._device_set = new
            self._account_publish(new, self._full_bytes(new), full=True,
                                  dirty=len(snaps),
                                  wall_ns=time.perf_counter_ns() - t0)
            return
        dirty = [d for d in range(len(snaps))
                 if snaps[d] is not cur.snapshots[d]]
        if not dirty:
            return
        new = self._delta_set(cur, snaps, dirty)
        # dirty rows' bytes + the re-shipped replicated offsets/router
        up = new.row_bytes() * len(dirty) + \
            new.replicated_bytes() * new.n_devices
        self._device_set = new
        self._account_publish(new, up, full=False, dirty=len(dirty),
                              wall_ns=time.perf_counter_ns() - t0)

    # ------------------------------------------------------------- write path
    def insert(self, key: float, value=None) -> None:
        """Buffer an insert in the owning shard's host writer (Alg. 4);
        invisible on device until that shard publishes."""
        with self._write_lock:
            self._host.insert(key, value)
            if self.publish_every is not None and \
                    self._host.pending_inserts >= self.publish_every:
                self.publish()

    def publish(self, shards: Sequence[int] | None = None,
                force: bool = False) -> dict[int, Snapshot]:
        """Cut new host epochs on dirty shards, then delta-upload exactly
        those shards' rows.  Clean shards keep their epoch *and* their row
        tensors.  Returns the newly installed snapshots."""
        with self._write_lock:
            published = self._host.publish(shards, force=force)
            self._sync_locked()
            return published

    def rebalance(self, force: bool = False) -> dict | None:
        """Recut boundaries on the host plane (migrating key runs between
        writers), then re-upload the full device layout -- a boundary change
        invalidates every row's routing, so there is no delta to take."""
        with self._write_lock:
            info = self._host.rebalance(force)
            if info is not None:
                self._sync_locked()
            return info

    def apply_plan(self, new_plan: "IndexPlan", *,
                   reshard: bool = False) -> "IndexPlan":
        """Hot-swap the served configuration (the ``Replanner`` path).  The
        shard count is pinned to the device count (``reshard`` only
        re-segments; it never changes D -- the row devices are fixed at
        construction), exchange/device hints carry over unless the new plan
        sets its own, and the device layout is fully re-uploaded."""
        with self._write_lock:
            host_plan = dataclasses.replace(
                new_plan, backend="numpy", n_shards=self.n_devices,
                publish_every=None, device_count=None, exchange=None)
            applied = self._host.apply_plan(host_plan, reshard=False)
            self.plan = dataclasses.replace(
                new_plan, backend="device", n_shards=applied.n_shards,
                device_count=self.n_devices,
                exchange=new_plan.exchange or self.exchange)
            self.exchange = self.plan.exchange
            self.publish_every = (self.plan.publish_every
                                  if self.plan.buffer_size > 0 else None)
            self._sync_locked()
            return self.plan

    # -------------------------------------------------------------- read path
    def _pad(self, flat: np.ndarray) -> np.ndarray:
        """Pad to a row-divisible batch with a finite filler (padding lanes
        compute real-but-discarded ranks; +inf would be routed to the last
        shard, which is also fine -- finite keeps the a2a buckets honest
        about real skew only)."""
        d = self.n_devices
        q_per = max(1, -(-flat.size // d))
        if flat.size == q_per * d:
            return flat
        out = np.zeros(q_per * d, np.float32)
        out[:flat.size] = flat
        return out

    def _home(self, flat: np.ndarray) -> torch.Tensor:
        """The batch on the first row's device (the controller's home)."""
        return torch.from_numpy(flat).to(self._devices[0])

    def _allgather(self, ds: DeviceShardSet, flat: np.ndarray,
                   side: str) -> np.ndarray:
        ranks = sharded_search_allgather(
            ds.d_seg_start, ds.d_slope, ds.d_base, ds.d_seg_end, ds.d_keys,
            ds.n_local, self._home(flat), devices=self._devices,
            error=ds.error, side=side, n_segments=ds.n_seg_local)
        return ranks.cpu().numpy().astype(np.int64)

    def _search_set(self, ds: DeviceShardSet, queries,
                    side: str) -> np.ndarray:
        """Global insertion ranks against a pinned manifest.  The exchange
        strategy is the service's (or the per-batch cost-model choice under
        ``"auto"``); a2a bucket overflow is resolved here with a follow-up
        allgather pass over just the overflowed queries."""
        q = np.asarray(queries, np.float64)
        flat = np.ascontiguousarray(q.astype(np.float32).ravel())
        if flat.size == 0:
            return np.empty(q.shape, np.int64)
        strategy = self.exchange
        if strategy == "auto":
            strategy = choose_exchange(flat.size, ds.n_devices, ds.error,
                                       ds.n_segments)
        if ds.n_devices == 1:
            strategy = "allgather"
        t0 = time.perf_counter_ns()
        if strategy == "a2a":
            ranks_d, ok_d = sharded_search_a2a(
                ds.d_seg_start, ds.d_slope, ds.d_base, ds.d_seg_end,
                ds.d_keys, ds.n_local, ds.d_offsets, ds.d_boundaries,
                self._home(self._pad(flat)), devices=self._devices,
                error=ds.error, side=side, slack=self.slack,
                n_segments=ds.n_seg_local)
            ranks = ranks_d.cpu().numpy().astype(np.int64)[:flat.size]
            miss = ~ok_d.cpu().numpy()[:flat.size]
            n_miss = int(miss.sum())
            if n_miss:
                # the follow-up pass the a2a contract promises: overflowed
                # queries re-ask via allgather, which cannot drop anything
                ranks[miss] = self._allgather(ds, flat[miss], side)
                with self._counts_lock:
                    self._overflow_queries += n_miss
                if self.monitor is not None:
                    self.monitor.record(CH_DEVICE_OVERFLOW, n_miss)
        else:
            ranks = self._allgather(ds, flat, side)
        wall = time.perf_counter_ns() - t0
        with self._counts_lock:
            self._xchg_counts[strategy] += 1
            self._collective_wall_ns += wall
        if self.monitor is not None:
            self.monitor.record(
                CH_DEVICE_COLLECTIVE,
                XCHG_A2A if strategy == "a2a" else XCHG_ALLGATHER,
                flat.size, wall)
        return ranks.reshape(q.shape)

    def search(self, queries, side: str = "left") -> np.ndarray:
        """Global ``searchsorted(all_keys, queries, side)`` insertion ranks
        (f32 key compares) via one fan-out over the rows."""
        check_side(side)
        self._count("searches", int(np.size(queries)))
        with sanitizer.pin_scope("device.search"):
            return self._search_set(self._pin_device_set(), queries, side)

    def lookup(self, queries) -> np.ndarray:
        """Global rank of each query, -1 if absent (found == some key equals
        the query in f32, i.e. right rank > left rank)."""
        self._count("points", int(np.size(queries)))
        with sanitizer.pin_scope("device.lookup"):
            ds = self._pin_device_set()
            left = self._search_set(ds, queries, "left")
            right = self._search_set(ds, queries, "right")
            return np.where(right > left, left, -1)

    def point(self, queries) -> PointResult:
        """Typed membership: global leftmost rank + found flag per query."""
        self._count("points", int(np.size(queries)))
        with sanitizer.pin_scope("device.point"):
            ds = self._pin_device_set()
            left = self._search_set(ds, queries, "left")
            right = self._search_set(ds, queries, "right")
            found = right > left
            return PointResult(rank=np.where(found, left, -1), found=found)

    def count(self, lo, hi) -> np.ndarray:
        """Keys in the inclusive ``[lo, hi]`` ranges (vectorized), both
        bounds resolved against one pinned manifest."""
        with sanitizer.pin_scope("device.count"):
            ds = self._pin_device_set()
            lo = np.asarray(lo, np.float64)
            hi = np.asarray(hi, np.float64)
            counts = np.maximum(self._search_set(ds, hi, "right")
                                - self._search_set(ds, lo, "left"), 0)
            self._count("counts", int(counts.size))
            return counts.astype(np.int64)

    def predecessor(self, queries) -> PointResult:
        """Global rank of the largest key <= each query (rightmost)."""
        self._count("predecessors", int(np.size(queries)))
        with sanitizer.pin_scope("device.predecessor"):
            ds = self._pin_device_set()
            rank = self._search_set(ds, queries, "right") - 1
            found = rank >= 0
            return PointResult(rank=np.where(found, rank, -1), found=found)

    def successor(self, queries) -> PointResult:
        """Global rank of the smallest key >= each query (leftmost)."""
        self._count("successors", int(np.size(queries)))
        with sanitizer.pin_scope("device.successor"):
            ds = self._pin_device_set()
            rank = self._search_set(ds, queries, "left")
            found = rank < ds.n_keys
            return PointResult(rank=np.where(found, rank, -1), found=found)

    def range(self, lo, hi, *, materialize: bool = True) -> RangeResult:
        """Inclusive ``[lo, hi]`` scan: the rank span comes from the device
        rows, the materialized keys/payloads from the SAME pinned manifest's
        host snapshots -- one epoch combination end to end."""
        lo, hi = check_range(lo, hi)
        with sanitizer.pin_scope("device.range"):
            ds = self._pin_device_set()
            self._count("ranges", 1)
            lo_rank = int(self._search_set(ds, np.asarray([lo]), "left")[0])
            hi_rank = max(int(self._search_set(ds, np.asarray([hi]),
                                               "right")[0]), lo_rank)
            keys = payload = None
            if materialize:
                d0 = int(route_keys(ds.boundaries, np.float64(lo)))
                d1 = int(route_keys(ds.boundaries, np.float64(hi)))
                k_parts, p_parts = [], []
                for d in range(d0, d1 + 1):
                    snap = ds.snapshots[d]
                    off = int(ds.offsets[d])
                    a = max(lo_rank - off, 0) if d == d0 else 0
                    b = (min(hi_rank - off, snap.n_keys) if d == d1
                         else snap.n_keys)
                    if b <= a:
                        continue
                    k_parts.append(snap.table.keys[a:b])
                    if snap.payload is not None:
                        p_parts.append(snap.payload[a:b])
                keys = (np.concatenate(k_parts) if k_parts
                        else np.empty(0, np.float64))
                if self._host.has_payload:
                    payload = (np.concatenate(p_parts) if p_parts
                               else np.empty(0))
            return RangeResult(lo=lo, hi=hi, lo_rank=lo_rank,
                               hi_rank=hi_rank, keys=keys, payload=payload)

    def prewarm(self, batch_sizes: Sequence[int] | None = None) -> None:
        """Run both sides at the given batch shapes before serving traffic,
        so the kernel library's first-use build is paid here."""
        for n in (batch_sizes or (self.n_devices,)):
            probe = np.zeros(int(n), np.float64)
            self.search(probe, side="left")
            self.search(probe, side="right")

    # ------------------------------------------------------------ observability
    def metrics(self):
        """The typed snapshot: the host plane's tree (shards, rebalances,
        imbalance) re-rooted at ``service="device"`` with this service's
        query counters and the :class:`DeviceMetrics` node -- manifest
        shape, per-device resident bytes, the delta-upload fraction, and
        the exchange-strategy counters."""
        base = self._host.metrics()
        ds = self._device_set
        with self._counts_lock:
            counts = dict(self._query_counts)
            xchg = dict(self._xchg_counts)
            overflow = self._overflow_queries
            wall = self._collective_wall_ns
        dm = DeviceMetrics(
            device_set_version=ds.version, n_devices=ds.n_devices,
            exchange=self.exchange, s_cap=ds.s_cap, m_cap=ds.m_cap,
            per_device_bytes=tuple(ds.row_bytes() + ds.replicated_bytes()
                                   for _ in range(ds.n_devices)),
            replicated_bytes=ds.replicated_bytes(),
            publishes=self._publishes,
            delta_publishes=self._delta_publishes,
            full_publishes=self._full_publishes,
            bytes_uploaded=self._bytes_uploaded,
            bytes_full_equivalent=self._bytes_full_equivalent,
            delta_fraction=(self._bytes_uploaded
                            / self._bytes_full_equivalent
                            if self._bytes_full_equivalent else 1.0),
            allgather_calls=xchg["allgather"], a2a_calls=xchg["a2a"],
            a2a_overflow_queries=overflow, collective_wall_ns=wall)
        return dataclasses.replace(base, service="device",
                                   plan_revision=self.plan.revision,
                                   query_counts=counts, device=dm)

    def stats(self) -> list:
        """Deprecated: use :meth:`metrics`\\ ``().shards``."""
        warnings.warn("DeviceShardedService.stats() is deprecated; use "
                      "metrics().shards", DeprecationWarning, stacklevel=2)
        return list(self.metrics().shards)


__all__ = ["DeviceShardSet", "DeviceShardedService", "sharded_lookup_a2a",
           "sharded_lookup_allgather", "sharded_search_a2a",
           "sharded_search_allgather"]
