"""The window-search kernel of batched FITing-Tree lookups (the paper's hot
path), hand-written in CUDA for Hopper, and its plain torch twin.

Replaces ``src/repro/kernels/fitting_lookup.py::fitting_lookup_pallas``.
After the (torch-side) router predicts each query's position, every query
owns a window of W = 2e+2 keys starting at ``qlo``; the kernel answers

    rank(q)  = qlo + #{ j in window : key(j) < q }   (<= for side="right")
    found(q) = any( j in window : key(j) == q )

with key(j) = +inf past the column's end (the reference's +inf padding to
``n_pad``).  The source, ``csrc/fitting_lookup.cu``, states what bounds the
kernel and what its design does about it.

* :func:`fitting_lookup_cuda` launches the kernel on CUDA tensors and counts
  its launches in ``fitting_lookup_cuda.launches``.
* :func:`fitting_lookup_torch` is the same function in plain torch ops.
* :func:`fitting_lookup_window` picks by device: the plain twin for CPU
  tensors only; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_i64 = ctypes.c_int64
_ptr = ctypes.c_void_p


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its launcher's C signature declared."""
    lib = _build.load("fitting_lookup")
    fn = lib.fitting_lookup_launch
    fn.argtypes = [_ptr, _i64, _ptr, _ptr, _i64, _i64, ctypes.c_int,
                   _ptr, _ptr, _ptr]
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
    fitting_lookup_cuda.launches += 1
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
