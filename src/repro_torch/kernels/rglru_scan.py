"""The RG-LRU linear recurrence, hand-written in CUDA for Hopper, and its
plain torch twin.

Replaces ``src/repro/kernels/rglru_scan.py::rglru_scan_pallas``.  Per
(batch, channel), independently::

    h_t = a_t * h_{t-1} + u_t,   h_{-1} = h0 (zeros when not given)

with u, a of shape (B, T, W) f32 and h0 of shape (B, W) f32; it returns
``(h, h_last)``: every state (B, T, W) and the last one (B, W), in f32.  It
is the prefill scan of every ``rglru`` block (``models/blocks.apply_rglru``).
The source, ``csrc/rglru_scan.cu``, states what bounds the kernel and what
its design does about it.

* :func:`rglru_scan_cuda` launches the kernel on CUDA tensors and counts its
  launches in ``rglru_scan_cuda.launches``.
* :func:`rglru_scan_torch` is the same recurrence as a loop over time in
  plain torch ops; its products and sums round as the kernel's do, so the
  two agree bit for bit.
* :func:`rglru_scan` picks by device: the plain twin for CPU tensors only;
  for a CUDA tensor it launches the kernel or raises.
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
    lib = _build.load("rglru_scan")
    fn = lib.rglru_scan_launch
    fn.argtypes = [_ptr, _ptr, _ptr, _i64, _i64, _i64, _ptr, _ptr, _ptr]
    fn.restype = ctypes.c_int
    return lib


def _check(u: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None) -> None:
    for name, t in (("u", u), ("a", a)):
        if t.dim() != 3 or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, T, W) float32 "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    if a.shape != u.shape or a.device != u.device:
        raise ValueError(f"u {tuple(u.shape)} and a {tuple(a.shape)} must "
                         f"share shape and device")
    if h0 is not None:
        b, _, w = u.shape
        if (h0.shape != (b, w) or h0.dtype != torch.float32
                or not h0.is_contiguous() or h0.device != u.device):
            raise ValueError(f"h0 must be a contiguous ({b}, {w}) float32 "
                             f"tensor on {u.device}, got {tuple(h0.shape)} "
                             f"{h0.dtype} on {h0.device}")


def rglru_scan_torch(u: torch.Tensor, a: torch.Tensor,
                     h0: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch ops: a loop over time."""
    _check(u, a, h0)
    b, t, w = u.shape
    h = torch.zeros((b, w), dtype=torch.float32, device=u.device) \
        if h0 is None else h0
    out = torch.empty_like(u)
    for i in range(t):
        h = a[:, i] * h + u[:, i]
        out[:, i] = h
    return out, h.clone()


def rglru_scan_cuda(u: torch.Tensor, a: torch.Tensor,
                    h0: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream (no synchronisation).

    Raises if the tensors are not on a CUDA device, the library cannot be
    built, or the launch reports an error."""
    _check(u, a, h0)
    if u.device.type != "cuda":
        raise ValueError(f"rglru_scan_cuda needs CUDA tensors, got {u.device}")
    b, t, w = u.shape
    lib = _library()
    out = torch.empty_like(u)
    h_last = torch.empty((b, w), dtype=torch.float32, device=u.device)
    if b == 0 or w == 0:
        return out, h_last
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.rglru_scan_launch(
            u.data_ptr(), a.data_ptr(), None if h0 is None else h0.data_ptr(),
            b, t, w, out.data_ptr(), h_last.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    rglru_scan_cuda.launches += 1
    return out, h_last


rglru_scan_cuda.launches = 0


def rglru_scan(u: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, its plain twin for CPU tensors."""
    if u.device.type == "cuda":
        return rglru_scan_cuda(u, a, h0)
    if u.device.type == "cpu":
        return rglru_scan_torch(u, a, h0)
    raise ValueError(f"no rglru_scan kernel for device {u.device}")
