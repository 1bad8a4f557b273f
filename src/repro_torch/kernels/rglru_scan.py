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

* :func:`rglru_scan_cuda` launches a kernel on CUDA tensors and counts its
  launches in ``rglru_scan_cuda.launches`` and, by path, in
  ``rglru_scan_cuda.launches_by_path``.  Which kernel takes which inputs
  (:func:`scan_path`): ``"tma"`` (a ring of tiles fed by TMA) where TMA can
  read u and a (W % 4 == 0, 16-byte aligned bases, T > 0), else
  ``"unaligned"`` (a thread a channel, any W and base).  Both round as the
  twin does.  Nothing falls back: a build or launch error raises.
* :func:`rglru_scan_torch` is the same recurrence as a loop over time in
  plain torch ops; its products and sums round as the kernel's do, so the
  two agree bit for bit.
* :func:`rglru_scan` picks by device: the plain twin for CPU tensors only;
  for a CUDA tensor it launches the kernel or raises; for a ``meta`` tensor
  it gives the outputs' shapes and nothing else (a step traced without a
  device).  Any other device raises.  It carries no gradient, so it
  refuses a CUDA tensor that requires one while grad mode is on
  (``_build.check_no_grad``): the training path goes through
  :class:`RGLRUScan`.
* ``torch.ops.repro_torch.rglru_scan`` is the same function as one
  registered op (launcher, twin, a shape-only fake on ``meta``, and a flop
  formula of 0: the recurrence has no products, nor has the reference's
  associative scan).  :func:`rglru_scan` calls it where a dispatch mode
  observes the call and on ``meta``, the launcher or the twin directly
  otherwise (the op's dispatcher would add host time to every launch).
* :class:`RGLRUScan` is the reference's ``_rglru_scan`` custom VJP
  (``src/repro/models/blocks.py``): its forward is the scan above from
  zeros and saves ``(a, h)``; its backward is the same recurrence run
  backwards in time, ``gacc_t = a_{t+1} gacc_{t+1} + g_t`` (``a_T`` taken as
  1), giving ``du = gacc`` and ``da = gacc * h_{t-1}`` (``h_{-1} = 0``),
  computed by :func:`rglru_scan_backward`: on the card one reverse-time
  kernel of its own (``rglru_scan_backward_cuda``, counted in
  ``rglru_scan_backward_cuda.launches`` and ``.launches_by_path``; the
  forward's counters count forward launches only), on the CPU its twin
  :func:`rglru_scan_backward_torch`, on ``meta`` or under a dispatch mode
  the registered op ``torch.ops.repro_torch.rglru_scan_backward`` (a
  shape-only fake, a flop formula of 0).  Kernel and twin round alike, so
  the backward on the card equals the twin's bit for bit, and both equal
  the forward scan run on time-flipped ``g`` and ``a_next`` (the port's
  backward before the kernel).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build

PATHS = ("tma", "unaligned")
_i64 = ctypes.c_int64
_ptr = ctypes.c_void_p
_COUNT_LOCK = threading.Lock()


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its launchers' C signatures declared."""
    lib = _build.load("rglru_scan")
    for path in PATHS:
        for name in (f"rglru_scan_{path}_launch",
                     f"rglru_scan_bwd_{path}_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [_ptr, _ptr, _ptr, _i64, _i64, _i64, _ptr, _ptr,
                           _ptr]
            fn.restype = ctypes.c_int
    return lib


def _check_btw(**named: torch.Tensor) -> None:
    """Each tensor a contiguous (B, T, W) f32, all of one shape and device."""
    (first, x), *rest = named.items()
    for name, t in named.items():
        if t.dim() != 3 or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, T, W) float32 "
                             f"tensor, got {tuple(t.shape)} {t.dtype}")
    for name, t in rest:
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{first} {tuple(x.shape)} and {name} "
                             f"{tuple(t.shape)} must share shape and device")


def _check(u: torch.Tensor, a: torch.Tensor, h0: torch.Tensor | None) -> None:
    _check_btw(u=u, a=a)
    if h0 is not None:
        b, _, w = u.shape
        if (h0.shape != (b, w) or h0.dtype != torch.float32
                or not h0.is_contiguous() or h0.device != u.device):
            raise ValueError(f"h0 must be a contiguous ({b}, {w}) float32 "
                             f"tensor on {u.device}, got {tuple(h0.shape)} "
                             f"{h0.dtype} on {h0.device}")


def scan_path(u: torch.Tensor, *others: torch.Tensor) -> str:
    """Which CUDA kernel serves these (B, T, W) f32 tensors (the forward's
    u and a; the backward's g, a and h): ``"tma"`` where TMA can read all
    of them (a 16-byte aligned base and row stride, so W % 4 == 0; and
    T > 0, since a tensor map has no empty axis), else ``"unaligned"``.  A
    pure function of shape and addresses."""
    _, t, w = u.shape
    aligned = all(x.data_ptr() % 16 == 0 for x in (u, *others))
    return "tma" if t > 0 and w % 4 == 0 and aligned else "unaligned"


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
    """Launch the CUDA kernel that :func:`scan_path` picks on the current
    stream (no synchronisation).

    Raises if the tensors are not on a CUDA device, the library cannot be
    built, or the launch reports an error."""
    return _rglru_scan_launch(u, a, h0, scan_path(u, a))


def _rglru_scan_launch(u: torch.Tensor, a: torch.Tensor,
                       h0: torch.Tensor | None, path: str
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel of ``path``: the wrapper's route, and for tests and
    the smoke the unaligned kernel on inputs the TMA kernel takes, to hold
    the two designs against each other.  Counted as every launch is."""
    _check(u, a, h0)
    if u.device.type != "cuda":
        raise ValueError(f"rglru_scan_cuda needs CUDA tensors, got {u.device}")
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if path == "tma" and scan_path(u, a) != "tma":
        raise ValueError(f"the TMA kernel needs W % 4 == 0, T > 0 and "
                         f"16-byte aligned bases; got {tuple(u.shape)} at "
                         f"{u.data_ptr():#x}, {a.data_ptr():#x}")
    b, t, w = u.shape
    lib = _library()
    out = torch.empty_like(u)
    h_last = torch.empty((b, w), dtype=torch.float32, device=u.device)
    if b == 0 or w == 0:
        return out, h_last
    launch = getattr(lib, f"rglru_scan_{path}_launch")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = launch(
            u.data_ptr(), a.data_ptr(), None if h0 is None else h0.data_ptr(),
            b, t, w, out.data_ptr(), h_last.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan {path} kernel launch failed: CUDA "
                           f"error {err} (1000: no tensor map encoded)")
    with _COUNT_LOCK:             # read-modify-writes, from any thread
        rglru_scan_cuda.launches += 1
        rglru_scan_cuda.launches_by_path[path] += 1
    return out, h_last


rglru_scan_cuda.launches = 0
rglru_scan_cuda.launches_by_path = dict.fromkeys(PATHS, 0)


def _direct(u, a, h0):
    """The launcher for CUDA tensors, the twin for CPU tensors; any other
    device raises."""
    if u.device.type == "cuda":
        return rglru_scan_cuda(u, a, h0)
    if u.device.type == "cpu":
        return rglru_scan_torch(u, a, h0)
    raise ValueError(f"no rglru_scan kernel for device {u.device}")


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def rglru_scan_op(u: torch.Tensor, a: torch.Tensor, h0: Optional[torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The registered op: the launcher on CUDA tensors, the twin on CPU
    tensors (the fake below serves ``meta``)."""
    return _direct(u, a, h0)


@rglru_scan_op.register_fake
def _rglru_scan_fake(u, a, h0):
    _check(u, a, h0)
    return torch.empty_like(u), u.new_empty((u.shape[0], u.shape[2]))


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def rglru_scan_flops(*args, out_shape=None, **kwargs) -> int:
    """0: elementwise products and sums only, no matrix product."""
    return 0


def rglru_scan(u: torch.Tensor, a: torch.Tensor,
               h0: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, its plain twin for CPU tensors, the
    outputs' shapes for ``meta`` tensors; through the registered op where a
    dispatch mode observes the call.  Not differentiable on the card: see
    :class:`RGLRUScan`."""
    if u.device.type == "cuda":
        _build.check_no_grad("rglru_scan", u, a, h0)
    if u.device.type == "meta" or _build.observed():
        return rglru_scan_op(u, a, h0)
    return _direct(u, a, h0)


# ------------------------------------------------------------- the backward
def rglru_scan_backward_torch(g: torch.Tensor, a: torch.Tensor,
                              h: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function in plain torch ops: a loop over time
    downward, ``gacc_t = a_{t+1} * gacc_{t+1} + g_t`` from ``gacc_T = 0``
    with ``a_T = 1``; ``du = gacc``, ``da = gacc * h_{t-1}`` with
    ``h_{-1} = 0``.  Each product and sum rounds as the kernel's do."""
    _check_btw(g=g, a=a, h=h)
    b, t, w = g.shape
    du, da = torch.empty_like(g), torch.empty_like(g)
    acc = torch.zeros((b, w), dtype=torch.float32, device=g.device)
    for i in reversed(range(t)):
        a_next = a[:, i + 1] if i + 1 < t else torch.ones_like(acc)
        acc = a_next * acc + g[:, i]
        du[:, i] = acc
        da[:, i] = acc * (h[:, i - 1] if i else torch.zeros_like(acc))
    return du, da


def rglru_scan_backward_cuda(g: torch.Tensor, a: torch.Tensor,
                             h: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel that :func:`scan_path` picks for g, a and
    h (du and da are fresh, aligned allocations) on the current stream.
    Raises as :func:`rglru_scan_cuda` does."""
    return _rglru_scan_backward_launch(g, a, h, scan_path(g, a, h))


def _rglru_scan_backward_launch(g: torch.Tensor, a: torch.Tensor,
                                h: torch.Tensor, path: str
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel of ``path`` (the unaligned one may take
    any input, for tests and the smoke).  An empty input launches nothing
    and counts nothing."""
    _check_btw(g=g, a=a, h=h)
    if g.device.type != "cuda":
        raise ValueError(f"rglru_scan_backward_cuda needs CUDA tensors, got "
                         f"{g.device}")
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if path == "tma" and scan_path(g, a, h) != "tma":
        raise ValueError(f"the TMA kernel needs W % 4 == 0, T > 0 and "
                         f"16-byte aligned bases; got {tuple(g.shape)} at "
                         f"{g.data_ptr():#x}, {a.data_ptr():#x}, "
                         f"{h.data_ptr():#x}")
    b, t, w = g.shape
    lib = _library()
    du, da = torch.empty_like(g), torch.empty_like(g)
    if b == 0 or t == 0 or w == 0:
        return du, da
    launch = getattr(lib, f"rglru_scan_bwd_{path}_launch")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = launch(g.data_ptr(), a.data_ptr(), h.data_ptr(), b, t, w,
                     du.data_ptr(), da.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan backward {path} kernel launch "
                           f"failed: CUDA error {err} (1000: no tensor map "
                           f"encoded)")
    with _COUNT_LOCK:
        rglru_scan_backward_cuda.launches += 1
        rglru_scan_backward_cuda.launches_by_path[path] += 1
    return du, da


rglru_scan_backward_cuda.launches = 0
rglru_scan_backward_cuda.launches_by_path = dict.fromkeys(PATHS, 0)


def _direct_backward(g, a, h):
    """As :func:`_direct`, for the backward."""
    if g.device.type == "cuda":
        return rglru_scan_backward_cuda(g, a, h)
    if g.device.type == "cpu":
        return rglru_scan_backward_torch(g, a, h)
    raise ValueError(f"no rglru_scan backward kernel for device {g.device}")


@torch.library.custom_op("repro_torch::rglru_scan_backward", mutates_args=())
def rglru_scan_backward_op(g: torch.Tensor, a: torch.Tensor, h: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The registered backward: the launcher on CUDA tensors, the twin on
    CPU tensors (the fake below serves ``meta``)."""
    return _direct_backward(g, a, h)


@rglru_scan_backward_op.register_fake
def _rglru_scan_backward_fake(g, a, h):
    _check_btw(g=g, a=a, h=h)
    return torch.empty_like(g), torch.empty_like(g)


@register_flop_formula(torch.ops.repro_torch.rglru_scan_backward)
def rglru_scan_backward_flops(*args, out_shape=None, **kwargs) -> int:
    """0, as the forward's: elementwise products and sums only."""
    return 0


def rglru_scan_backward(g: torch.Tensor, a: torch.Tensor, h: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(du, da)`` of :class:`RGLRUScan` from the output's gradient ``g``
    and the saved ``a`` and ``h``: the backward kernel for CUDA tensors, its
    twin for CPU tensors, the shapes for ``meta``; through the registered
    op where a dispatch mode observes the call."""
    if g.device.type == "cuda":
        _build.check_no_grad("rglru_scan_backward", g, a, h)
    if g.device.type == "meta" or _build.observed():
        return rglru_scan_backward_op(g, a, h)
    return _direct_backward(g, a, h)


class RGLRUScan(torch.autograd.Function):
    """``h = RGLRUScan.apply(u, a)``: every state of ``h_t = a_t h_{t-1}
    + u_t`` from ``h_{-1} = 0``, differentiable in ``u`` and ``a``.  u, a:
    contiguous (B, T, W) f32.  The kernel on the card, the twin on the CPU,
    in both directions."""

    @staticmethod
    def forward(ctx, u: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        h, _ = rglru_scan(u, a)        # grad mode is off inside forward
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, h = ctx.saved_tensors
        return rglru_scan_backward(g.contiguous(), a, h)
