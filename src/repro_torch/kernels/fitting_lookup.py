"""The FITing-Tree lookup (the paper's hot path) hand-written in CUDA for
Hopper, and its plain torch twins.

Replaces ``src/repro/kernels/fitting_lookup.py::fitting_lookup_pallas`` and
the XLA work the reference runs around it.  Two entries share one device
code path (``csrc/fitting_lookup.cu``, which states what bounds the kernel
and what its design does about it):

* the fused search, :func:`fitting_search_cuda`: route each query to its
  segment, interpolate its position, search the W = 2e+2 window around it
  and snap duplicate runs, all in one launch with no host sync.  ``mode``
  is ``"lookup"`` (the leftmost rank of an equal key, -1 if absent),
  ``"search-left"`` or ``"search-right"`` (``np.searchsorted`` ranks).
  :func:`fitting_search_torch` is its twin: ``predict_positions`` ->
  window clamp -> :func:`fitting_lookup_torch` -> ``snap_leftmost`` /
  ``snap_side``; :func:`fitting_search` picks by device.
* the window search alone, :func:`fitting_lookup_cuda`: every query owns
  a window of W keys starting at a given ``qlo`` and the kernel answers

      rank(q)  = qlo + #{ j in window : key(j) < q }   (<= for side="right")
      found(q) = any( j in window : key(j) == q )

  with key(j) = +inf past the column's end (the reference's +inf padding
  to ``n_pad``).  :func:`fitting_lookup_torch` is its twin and
  :func:`fitting_lookup_window` picks by device.

Each CUDA entry counts its launches (``fitting_search_cuda.launches``,
``fitting_lookup_cuda.launches``), under a lock, since serving threads
launch concurrently; a caller reads a count or sets it to 0.  The twins
serve CPU tensors only: for a
CUDA tensor the dispatchers launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.index.device import (DeviceIndex, predict_positions,
                                      snap_leftmost, snap_side)

from . import _build

_i64 = ctypes.c_int64
_ptr = ctypes.c_void_p
_COUNT_LOCK = threading.Lock()


def _count_launch(fn) -> None:
    """Add one to ``fn.launches``: a read-modify-write, so under a lock."""
    with _COUNT_LOCK:
        fn.launches += 1


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its launcher's C signature declared."""
    lib = _build.load("fitting_lookup")
    fn = lib.fitting_lookup_launch
    fn.argtypes = [_ptr, _i64, _ptr, _ptr, _i64, _i64, ctypes.c_int,
                   _ptr, _ptr, _ptr]
    fn.restype = ctypes.c_int
    fn = lib.fitting_search_launch
    fn.argtypes = [_ptr, _ptr, _ptr, _ptr, _i64, _ptr, _i64, _ptr, _i64, _i64,
                   _i64, ctypes.c_int, _ptr, _ptr]
    fn.restype = ctypes.c_int
    return lib


def _check(keys: torch.Tensor, queries: torch.Tensor, qlo: torch.Tensor,
           window: int, n_pad: int, side: str) -> None:
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    for name, t, dtype in (("keys", keys, torch.float32),
                           ("queries", queries, torch.float32),
                           ("qlo", qlo, torch.int32)):
        if t.dim() != 1 or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    if queries.shape != qlo.shape:
        raise ValueError(f"queries {tuple(queries.shape)} and qlo "
                         f"{tuple(qlo.shape)} differ in shape")
    if not (queries.device == qlo.device == keys.device):
        raise ValueError("keys, queries and qlo must share one device")
    if window < 1 or n_pad < max(keys.shape[0], window):
        raise ValueError(f"need window >= 1 and n_pad >= max(n, window), got "
                         f"{window=} {n_pad=} n={keys.shape[0]}")


def fitting_lookup_torch(keys: torch.Tensor, queries: torch.Tensor,
                         qlo: torch.Tensor, *, window: int, n_pad: int,
                         side: str = "left"
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch ops: gather each window from the
    column extended by one +inf, compare and reduce."""
    _check(keys, queries, qlo, window, n_pad, side)
    n = keys.shape[0]
    ext = torch.cat([keys, keys.new_full((1,), float("inf"))])
    offs = qlo[:, None] + torch.arange(window, dtype=torch.int32,
                                       device=qlo.device)[None, :]
    vals = ext[offs.clamp(max=n)]
    q = queries[:, None]
    below = (vals < q) if side == "left" else (vals <= q)
    rank = qlo + below.sum(1, dtype=torch.int32)
    return rank, (vals == q).any(1)


def fitting_lookup_cuda(keys: torch.Tensor, queries: torch.Tensor,
                        qlo: torch.Tensor, *, window: int, n_pad: int,
                        side: str = "left"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream (no synchronisation).

    Returns ``(rank i32, found bool)``, one per query.  Raises if the
    tensors are not on a CUDA device, the library cannot be built, or the
    launch reports an error."""
    _check(keys, queries, qlo, window, n_pad, side)
    if keys.device.type != "cuda":
        raise ValueError(f"fitting_lookup_cuda needs CUDA tensors, got "
                         f"{keys.device}")
    nq = queries.shape[0]
    rank = torch.empty(nq, dtype=torch.int32, device=keys.device)
    found = torch.empty(nq, dtype=torch.bool, device=keys.device)
    if nq == 0:
        return rank, found
    lib = _library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.fitting_lookup_launch(
            keys.data_ptr(), keys.shape[0], queries.data_ptr(),
            qlo.data_ptr(), nq, window, int(side == "right"),
            rank.data_ptr(), found.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fitting_lookup kernel launch failed: CUDA error "
                           f"{err}")
    _count_launch(fitting_lookup_cuda)
    return rank, found


fitting_lookup_cuda.launches = 0


def fitting_lookup_window(keys: torch.Tensor, queries: torch.Tensor,
                          qlo: torch.Tensor, *, window: int, n_pad: int,
                          side: str = "left"
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, its plain twin for CPU tensors."""
    if keys.device.type == "cuda":
        return fitting_lookup_cuda(keys, queries, qlo, window=window,
                                   n_pad=n_pad, side=side)
    if keys.device.type == "cpu":
        return fitting_lookup_torch(keys, queries, qlo, window=window,
                                    n_pad=n_pad, side=side)
    raise ValueError(f"no fitting_lookup kernel for device {keys.device}")


# ------------------------------------------------------------ fused search
MODES = ("lookup", "search-left", "search-right")


def _check_search(seg_start: torch.Tensor, slope: torch.Tensor,
                  base: torch.Tensor, seg_end: torch.Tensor,
                  keys: torch.Tensor, queries: torch.Tensor, error: int,
                  n_pad: int, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    tensors = (("seg_start", seg_start, torch.float32),
               ("slope", slope, torch.float32),
               ("base", base, torch.int32), ("seg_end", seg_end, torch.int32),
               ("keys", keys, torch.float32),
               ("queries", queries, torch.float32))
    for name, t, dtype in tensors:
        if t.dim() != 1 or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
        if t.device != keys.device:
            raise ValueError("the index tensors and the queries must share "
                             "one device")
    s = seg_start.shape[0]
    if not (slope.shape[0] == base.shape[0] == seg_end.shape[0] == s >= 1):
        lens = [t.shape[0] for t in (seg_start, slope, base, seg_end)]
        raise ValueError(f"the segment fields must share one length >= 1, "
                         f"got {lens}")
    window = 2 * error + 2
    if error < 0 or keys.shape[0] < 1 or n_pad < max(keys.shape[0], window):
        raise ValueError(f"need error >= 0, n >= 1 and n_pad >= max(n, 2e+2), "
                         f"got {error=} {n_pad=} n={keys.shape[0]}")


def fitting_search_torch(seg_start: torch.Tensor, slope: torch.Tensor,
                         base: torch.Tensor, seg_end: torch.Tensor,
                         keys: torch.Tensor, queries: torch.Tensor, *,
                         error: int, n_pad: int, mode: str) -> torch.Tensor:
    """The fused kernel's function as the plain composition: route +
    interpolate (``predict_positions``), clamp the window start to
    ``[0, n_pad - W]``, the window twin, then the duplicate snap."""
    _check_search(seg_start, slope, base, seg_end, keys, queries, error,
                  n_pad, mode)
    idx = DeviceIndex(seg_start, slope, base, seg_end, keys, error)
    window = 2 * error + 2
    qlo = (predict_positions(idx, queries) - error).clamp(0, n_pad - window)
    side = "right" if mode == "search-right" else "left"
    rank, found = fitting_lookup_torch(keys, queries, qlo, window=window,
                                       n_pad=n_pad, side=side)
    if mode == "lookup":
        res = torch.where(found, rank, -1)
        return snap_leftmost(keys, queries, res, res >= 0)
    return snap_side(keys, queries, rank, side)


def fitting_search_cuda(seg_start: torch.Tensor, slope: torch.Tensor,
                        base: torch.Tensor, seg_end: torch.Tensor,
                        keys: torch.Tensor, queries: torch.Tensor, *,
                        error: int, n_pad: int, mode: str) -> torch.Tensor:
    """Launch the fused kernel on the current stream (no synchronisation):
    one int32 per query.  Raises if the tensors are not on a CUDA device,
    the library cannot be built, or the launch reports an error."""
    _check_search(seg_start, slope, base, seg_end, keys, queries, error,
                  n_pad, mode)
    if keys.device.type != "cuda":
        raise ValueError(f"fitting_search_cuda needs CUDA tensors, got "
                         f"{keys.device}")
    nq = queries.shape[0]
    out = torch.empty(nq, dtype=torch.int32, device=keys.device)
    if nq == 0:
        return out
    lib = _library()
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.fitting_search_launch(
            seg_start.data_ptr(), slope.data_ptr(), base.data_ptr(),
            seg_end.data_ptr(), seg_start.shape[0], keys.data_ptr(),
            keys.shape[0], queries.data_ptr(), nq, error, n_pad,
            MODES.index(mode), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fitting_search kernel launch failed: CUDA error "
                           f"{err}")
    _count_launch(fitting_search_cuda)
    return out


fitting_search_cuda.launches = 0


def fitting_search(seg_start: torch.Tensor, slope: torch.Tensor,
                   base: torch.Tensor, seg_end: torch.Tensor,
                   keys: torch.Tensor, queries: torch.Tensor, *, error: int,
                   n_pad: int, mode: str) -> torch.Tensor:
    """The fused kernel for CUDA tensors, its plain twin for CPU tensors."""
    args = (seg_start, slope, base, seg_end, keys, queries)
    kw = {"error": error, "n_pad": n_pad, "mode": mode}
    if keys.device.type == "cuda":
        return fitting_search_cuda(*args, **kw)
    if keys.device.type == "cpu":
        return fitting_search_torch(*args, **kw)
    raise ValueError(f"no fitting_search kernel for device {keys.device}")
