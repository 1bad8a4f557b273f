"""`LookupEngine`: one bounded-window search implementation per backend.

Port of ``repro.index.engine``.  Each backend mirrors one of the reference:

    numpy         (numpy)       host vectorized bounded bisect, f64 keys
    torch-window  (xla-window)  gather the 2e+2 window and compare-reduce
    torch-bisect  (xla-bisect)  log2(2e+2) halving steps of single gathers
    cuda          (pallas)      the hand-written CUDA fused search kernel
                                (``repro_torch.kernels.fitting_lookup``)
    dispatch      (dispatch)    batch-size tiers over the above

``make_engine(table, backend="cuda", device=None)`` returns an engine whose
``lookup`` maps a query batch to global ranks (-1 if absent; the *leftmost*
rank for duplicated keys) and whose ``search(queries, side)`` returns
``np.searchsorted`` insertion ranks, from which ``repro_torch.index.query``
derives point / range / count / predecessor / successor.  Device backends
place the table's f32/i32 form on an explicit torch device: ``None`` means
``"cuda"`` and raises where no card is present, so nothing quietly runs on
the CPU; ``device="cpu"`` runs the same code on the CPU, where the ``cuda``
backend runs its kernel's plain torch twin.

Backends return identical ranks for any key column whose keys and queries
are exact in f32 (integer keys < 2^24, the serving regime -- see
``rescale_keys``): ``numpy`` compares in f64, the device backends in f32.

Every device path ends in a duplicate snap (``snap_leftmost`` /
``snap_side``).  The torch backends pay one host sync per batch for it: it
reads which queries landed inside a duplicate run before running
``torch.searchsorted`` over the column for just those queries (the
reference gates the same work with ``lax.cond``).  The ``cuda`` backend's
fused kernel snaps on the device, with no sync.
"""
from __future__ import annotations

import functools
import time
from typing import Callable, Literal, NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.analysis.contracts import hot_path
from repro_torch.analysis.sanitizer import make_lock
from repro_torch.core.cost_model import dispatch_thresholds

from .device import (DeviceIndex, predict_positions, snap_leftmost,
                     snap_side)
from .query import QueryVerbs, check_side
from .table import SegmentTable, numpy_lookup, numpy_search
from .telemetry import span


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: ``None`` means the current
    CUDA card.  Raises where CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "torch backends on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_index(table: SegmentTable, device=None) -> DeviceIndex:
    """Convert (and cache on the table, per device -- snapshots are shared
    by engines).  Table arrays are read-only, so each is copied into a fresh
    tensor rather than shared.  A table with an ``assemble(device)`` method
    (a sharded view's, ``repro_torch.index.sharded.ViewTable``) builds its
    device form itself, from its parts' device forms."""
    dev = resolve_device(device)
    idx = table._device_cache.get(dev)
    if idx is None:
        assemble = getattr(table, "assemble", None)
        if assemble is not None:
            idx = assemble(dev)
        else:
            def put(arr, dtype):
                return torch.tensor(np.asarray(arr, dtype), device=dev)
            idx = DeviceIndex(
                seg_start=put(table.start_key, np.float32),
                slope=put(table.slope, np.float32),
                base=put(table.base, np.int32),
                seg_end=put(table.seg_end, np.int32),
                keys=put(table.keys, np.float32),
                error=int(table.error),
            )
        table._device_cache[dev] = idx
    return idx


# --------------------------------------------------------------------- device
def _window(idx: DeviceIndex, start: torch.Tensor) -> tuple[torch.Tensor,
                                                            torch.Tensor]:
    """Gather the 2e+2 keys from each window start: (offsets, values), with
    gathers past the column clamped to its last key."""
    n = idx.keys.shape[0]
    w = 2 * idx.error + 2
    offs = start[:, None] + torch.arange(w, dtype=torch.int32,
                                         device=start.device)[None, :]
    return offs, idx.keys[offs.clamp(max=n - 1)]


def _bisect(idx: DeviceIndex, queries: torch.Tensor, pred: torch.Tensor,
            side: str) -> torch.Tensor:
    """log2(2e+2) halving steps on the clipped +-error window."""
    n = idx.keys.shape[0]
    e = idx.error
    lo = (pred - e).clamp(0, n)
    hi = (pred + e + 1).clamp(0, n)
    for _ in range(int(np.ceil(np.log2(2 * e + 2)))):
        mid = (lo + hi) // 2
        v = idx.keys[mid.clamp(max=n - 1)]
        ok = (v < queries) if side == "left" else (v <= queries)
        go = ok & (lo < hi)
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go, hi, mid)
    return lo


def torch_lookup(idx: DeviceIndex, queries: torch.Tensor,
                 strategy: Literal["window", "bisect"] = "window"
                 ) -> torch.Tensor:
    """Batched point lookup, rank or -1 (twin of ``xla_lookup``)."""
    n = idx.keys.shape[0]
    pred = predict_positions(idx, queries)
    e = idx.error
    if strategy == "window":
        w = 2 * e + 2
        start = (pred - e).clamp(0, max(n - w, 0))
        _, vals = _window(idx, start)
        rank = start + (vals < queries[:, None]).sum(1, dtype=torch.int32)
        hit = (vals == queries[:, None]).any(1)
        rank = snap_leftmost(idx.keys, queries, rank, hit)
        return torch.where(hit, rank, -1)
    lo = _bisect(idx, queries, pred, "left")
    ok = (lo < n) & (idx.keys[lo.clamp(max=n - 1)] == queries)
    lo = snap_leftmost(idx.keys, queries, lo, ok)
    return torch.where(ok, lo, -1)


def torch_search(idx: DeviceIndex, queries: torch.Tensor, side: str = "left",
                 strategy: Literal["window", "bisect"] = "bisect"
                 ) -> torch.Tensor:
    """Batched bounded-window rank search (twin of ``xla_search``): the
    insertion rank ``searchsorted(keys, q, side)`` of every query, via the
    interpolated +-error window and a final :func:`snap_side`."""
    check_side(side)
    n = idx.keys.shape[0]
    pred = predict_positions(idx, queries)
    e = idx.error
    if strategy == "window":
        w = 2 * e + 2
        start = (pred - e).clamp(0, max(n - w, 0))
        offs, vals = _window(idx, start)
        q = queries[:, None]
        cmp = (vals < q) if side == "left" else (vals <= q)
        rank = start + ((offs < n) & cmp).sum(1, dtype=torch.int32)
        return snap_side(idx.keys, queries, rank, side)
    lo = _bisect(idx, queries, pred, side)
    return snap_side(idx.keys, queries, lo, side)


# ----------------------------------------------------------------------- cuda
def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class LookupPlan(NamedTuple):
    """Static window geometry for a (N, error) pair (the reference kernel's
    plan; the CUDA kernel reads only ``window`` and ``n_pad``)."""
    kb: int         # key block size of the reference kernel
    window: int     # 2*error + 2
    n_blocks: int
    n_pad: int      # window starts are clamped to [0, n_pad - window]


def make_plan(n_keys: int, error: int) -> LookupPlan:
    window = 2 * error + 2
    kb = max(128, _round_up(window, 128))
    n_pad = _round_up(max(n_keys, kb), kb)
    return LookupPlan(kb=kb, window=window, n_blocks=n_pad // kb, n_pad=n_pad)


def _fused(idx: DeviceIndex, queries: torch.Tensor, mode: str
           ) -> torch.Tensor:
    """The fused search (route, predict, window, snap) over the reference
    kernel's window: ``clip(pred - e, 0, n_pad - W)``, kept exactly.  One
    launch and no host sync for CUDA tensors; the plain composition for CPU
    tensors."""
    # lazy: repro_torch.kernels imports this module for its thin wrappers
    from repro_torch.kernels.fitting_lookup import fitting_search

    plan = make_plan(int(idx.keys.shape[0]), int(idx.error))
    return fitting_search(idx.seg_start, idx.slope, idx.base, idx.seg_end,
                          idx.keys, queries, error=int(idx.error),
                          n_pad=plan.n_pad, mode=mode)


def kernel_lookup(idx: DeviceIndex, queries: torch.Tensor) -> torch.Tensor:
    """Batched point lookup via the fused kernel (twin of ``pallas_lookup``).
    Returns ranks (the leftmost of a duplicate run), -1 where absent."""
    return _fused(idx, queries, "lookup")


def kernel_search(idx: DeviceIndex, queries: torch.Tensor,
                  side: str = "left") -> torch.Tensor:
    """Batched insertion-rank search via the fused kernel (twin of
    ``pallas_search``): the window counts with the side's comparison, and
    the snap resolves duplicate runs extending past the window."""
    check_side(side)
    return _fused(idx, queries, f"search-{side}")


# ------------------------------------------------------------------- registry
@runtime_checkable
class LookupEngine(Protocol):
    """A lookup path over one immutable SegmentTable snapshot.

    Every registered backend implements ``lookup`` and the query plane's
    primitive ``search(queries, side)`` (host arrays in and out) and, via the
    :class:`repro_torch.index.query.QueryVerbs` mixin, the typed verbs."""
    backend: str
    table: SegmentTable

    def lookup(self, queries) -> np.ndarray:
        """Global rank of each query, -1 if absent (host array out)."""
        ...

    def search(self, queries, side: str = "left") -> np.ndarray:
        """``searchsorted(keys, queries, side)`` insertion ranks (host array
        out): the one primitive every typed query verb derives from."""
        ...


_BACKENDS: dict[str, Callable[..., LookupEngine]] = {}


def register_backend(name: str):
    def deco(cls):
        cls.backend = name
        _BACKENDS[name] = cls
        return cls
    return deco


def available_backends() -> list[str]:
    return sorted(_BACKENDS)


def make_engine(table: SegmentTable, backend: str = "cuda", *, device=None,
                monitor=None, **opts) -> LookupEngine:
    """The one constructor every layer goes through to get a lookup path.

    The default is the CUDA kernel's backend.  ``device`` places a device
    backend (``None``: the CUDA card, raising if there is none); the host
    ``numpy`` backend, which only a caller that names it gets, has none.
    ``monitor`` (a ``repro_torch.index.telemetry.Monitor``) goes to every
    device backend, which records its host spans there."""
    try:
        cls = _BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"available: {available_backends()}") from None
    if getattr(cls, "uses_device", False):
        opts["device"] = device
        opts["monitor"] = monitor
    return cls(table, **opts)


def serving_device(backend: str,
                   engine_opts: dict[str, dict] | None = None) -> torch.device:
    """The device ``backend``'s tables serve on: the host for a backend
    without one (``numpy``), else its ``device`` option, None naming the
    CUDA card (left unresolved, so asking needs no card)."""
    try:
        cls = _BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"available: {available_backends()}") from None
    if not getattr(cls, "uses_device", False):
        return torch.device("cpu")
    dev = (engine_opts or {}).get(backend, {}).get("device")
    return torch.device("cuda" if dev is None else dev)


def inject_monitor(engine_opts: dict[str, dict] | None,
                   monitor) -> dict[str, dict]:
    """``engine_opts`` with ``monitor`` threaded into every device backend's
    kwargs (the dispatch tiers' latency hook and the engines' spans),
    without mutating the caller's / the plan's dict."""
    opts = {k: dict(v) for k, v in (engine_opts or {}).items()}
    if monitor is not None:
        for name, cls in _BACKENDS.items():
            if getattr(cls, "uses_device", False):
                opts.setdefault(name, {})["monitor"] = monitor
    return opts


def _prewarm_queries(table: SegmentTable, size: int) -> np.ndarray:
    """A representative warm-up batch: real keys cycled to ``size``."""
    sample = np.asarray(table.keys[: min(table.n_keys, size)], np.float64)
    return np.resize(sample, size)


@register_backend("numpy")
class NumpyEngine(QueryVerbs):
    def __init__(self, table: SegmentTable):
        self.table = table
        self.fn = functools.partial(numpy_lookup, table)

    def lookup(self, queries) -> np.ndarray:
        return self.fn(queries)

    def search(self, queries, side: str = "left") -> np.ndarray:
        return numpy_search(self.table, queries, side)

    def prewarm(self, batch_sizes=None) -> None:
        """No-op: the host path has nothing to build."""


class _DeviceEngine(QueryVerbs):
    """Shared scaffolding: place the table on the device once; each backend
    names its point-lookup and search functions over the device form."""
    uses_device = True

    def __init__(self, table: SegmentTable, *, device=None, monitor=None):
        self.table = table
        self.device = resolve_device(device)
        self.index = device_index(table, self.device)
        self.monitor = monitor

    def _lookup(self, idx: DeviceIndex, q: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _search(self, idx: DeviceIndex, q: torch.Tensor,
                side: str) -> torch.Tensor:
        raise NotImplementedError

    def _queries(self, queries) -> tuple[torch.Tensor, tuple]:
        """Host or device queries -> a flat f32 tensor on this device (the
        host staging under ``engine.stage``; the copy itself is not)."""
        with span(self.monitor, "engine.stage"):
            if isinstance(queries, torch.Tensor):
                q = queries
            else:
                q = torch.from_numpy(np.array(queries, np.float32))
        q = q.to(self.device, torch.float32)
        return q.reshape(-1), tuple(q.shape)

    def lookup(self, queries) -> np.ndarray:
        if self.table.n_keys == 0:   # empty table: every probe misses
            return np.full(np.shape(queries), -1, np.int64)
        q, shape = self._queries(queries)
        out = self._lookup(self.index, q).cpu()
        with span(self.monitor, "engine.cast"):
            return out.numpy().reshape(shape)

    def search(self, queries, side: str = "left") -> np.ndarray:
        check_side(side)
        if self.table.n_keys == 0:   # empty table: every rank is 0
            return np.zeros(np.shape(queries), np.int64)
        q, shape = self._queries(queries)
        out = self._search(self.index, q, side).cpu()
        with span(self.monitor, "engine.cast"):
            return out.numpy().astype(np.int64).reshape(shape)

    def prewarm(self, batch_sizes=None) -> None:
        """Run the lookup and both search sides once at each batch size, so
        a kernel's first-use build is paid here.  Default one size."""
        if self.table.n_keys == 0:
            return
        for size in batch_sizes or (256,):
            q = _prewarm_queries(self.table, int(size))
            self.lookup(q)
            self.search(q, "left")
            self.search(q, "right")


@register_backend("torch-window")
class TorchWindowEngine(_DeviceEngine):
    def _lookup(self, idx, q):
        return torch_lookup(idx, q, "window")

    def _search(self, idx, q, side):
        return torch_search(idx, q, side, "window")


@register_backend("torch-bisect")
class TorchBisectEngine(_DeviceEngine):
    def _lookup(self, idx, q):
        return torch_lookup(idx, q, "bisect")

    def _search(self, idx, q, side):
        return torch_search(idx, q, side, "bisect")


@register_backend("cuda")
class CudaEngine(_DeviceEngine):
    def _lookup(self, idx, q):
        return kernel_lookup(idx, q)

    def _search(self, idx, q, side):
        return kernel_search(idx, q, side)


@register_backend("dispatch")
class DispatchEngine(QueryVerbs):
    """Batch-size-aware backend dispatch over one snapshot.

    The backends trade fixed cost against per-query cost: numpy wins for
    tiny probes (no device round trip), the torch bisect for medium batches,
    and the fused CUDA search kernel for large fan-out.  Each ``lookup`` /
    ``search`` batch goes to the tier its size puts it in:

        size <= small_max            -> numpy
        small_max < size < large_min -> torch-bisect
        size >= large_min            -> cuda

    Tier engines are built lazily on first use and cached for the lifetime
    of this engine (i.e. of the snapshot).  Every tier returns identical
    ranks for exact-f32 workloads, so dispatch preserves semantics.

    ``small_max``/``large_min`` default to ``None``: the thresholds are then
    the batch sizes where the Sec. 6 cost model's tier curves cross for this
    table's error and segment count, under the card's default profile
    (:func:`repro_torch.core.cost_model.dispatch_thresholds`).  Pass both to
    pin them (e.g. from an ``IndexPlan``).

    ``monitor`` (a ``repro_torch.index.telemetry.Monitor``) turns on per-tier
    telemetry: every routed ``lookup``/``search`` records ``(batch_size,
    wall_ns)`` on the ``tier.<small|medium|large>`` channel, the samples
    ``fit_tier_curves`` re-fits the tier curves from.
    """
    uses_device = True
    TIERS = ("numpy", "torch-bisect", "cuda")   # small, medium, large

    def __init__(self, table: SegmentTable, *, small_max: int | None = None,
                 large_min: int | None = None, device=None, monitor=None):
        if small_max is None and large_min is None:
            small_max, large_min = dispatch_thresholds(table.error,
                                                       table.n_segments)
        if small_max is None or large_min is None:
            raise ValueError("pass both small_max and large_min, or neither "
                             "(None defers both to the cost model)")
        if not 0 <= small_max < large_min:
            raise ValueError(f"need 0 <= small_max < large_min, got "
                             f"{small_max=} {large_min=}")
        self.table = table
        self.device = resolve_device(device)
        self.small_max = int(small_max)
        self.large_min = int(large_min)
        self.monitor = monitor
        self._engines: dict[str, LookupEngine] = {}
        self._lock = make_lock("DispatchEngine._lock")

    def tier_for(self, batch_size: int) -> str:
        """The tier (``small``/``medium``/``large``) a batch routes to."""
        if batch_size <= self.small_max:
            return "small"
        return "medium" if batch_size < self.large_min else "large"

    def backend_for(self, batch_size: int) -> str:
        """The tier backend a batch of ``batch_size`` queries dispatches to."""
        small, medium, large = self.TIERS
        return {"small": small, "medium": medium,
                "large": large}[self.tier_for(batch_size)]

    def engine_for(self, batch_size: int) -> LookupEngine:
        name = self.backend_for(batch_size)
        eng = self._engines.get(name)
        if eng is None:
            with self._lock:           # don't build the same tier twice
                eng = self._engines.get(name)
                if eng is None:
                    eng = make_engine(self.table, name, device=self.device,
                                      monitor=self.monitor)
                    self._engines[name] = eng
        return eng

    @hot_path
    def lookup(self, queries) -> np.ndarray:
        n = int(np.size(queries))
        eng = self.engine_for(n)
        mon = self.monitor
        if mon is None:
            return eng.lookup(queries)
        t0 = time.perf_counter_ns()
        out = eng.lookup(queries)
        # channel name matches repro_torch.index.telemetry.CH_TIER_PREFIX
        mon.record("tier." + self.tier_for(n), n, time.perf_counter_ns() - t0)
        return out

    @hot_path
    def search(self, queries, side: str = "left") -> np.ndarray:
        """The query plane's primitive, routed by batch size like ``lookup``."""
        n = int(np.size(queries))
        eng = self.engine_for(n)
        mon = self.monitor
        if mon is None:
            return eng.search(queries, side)
        t0 = time.perf_counter_ns()
        out = eng.search(queries, side)
        mon.record("tier." + self.tier_for(n), n, time.perf_counter_ns() - t0)
        return out

    def prewarm(self, batch_sizes=None) -> None:
        """Opt-in eager tier construction: build each tier a batch size maps
        to and run it once at that size (default one size per tier)."""
        if batch_sizes is None:
            batch_sizes = [self.large_min]
            if self.small_max >= 1:
                batch_sizes.append(self.small_max)
            if self.small_max + 1 < self.large_min:
                batch_sizes.append(self.small_max + 1)
        for size in batch_sizes:
            eng = self.engine_for(int(size))
            warm = getattr(eng, "prewarm", None)
            if warm is not None:
                warm(batch_sizes=(int(size),))


__all__ = [
    "DeviceIndex", "DispatchEngine", "LookupEngine", "LookupPlan",
    "available_backends", "device_index", "inject_monitor", "kernel_lookup",
    "kernel_search", "make_engine", "make_plan", "predict_positions",
    "register_backend",
    "resolve_device", "serving_device", "snap_leftmost", "snap_side",
    "torch_lookup",
    "torch_search",
]
