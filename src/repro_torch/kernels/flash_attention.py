"""Blocked (flash) attention forward, hand-written in CUDA for Hopper, and
its plain torch twin.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention``: causal
and sliding-``window`` masks, tanh logit ``softcap``, grouped-query heads
(q head h reads kv head ``h // (H / Hkv)``), queries aligned to the end of
the keys (``q_offset = S - Tq``), f32 accumulation, output in q's type.
q is (B, H, Tq, hd); k and v are (B, Hkv, S, hd), all f32 or all bf16.  It
is the prefill attention of every ``attn`` and ``local`` block
(``models/blocks.apply_attention``, with ``q_offset = 0``).  The source,
``csrc/flash_attention.cu``, states what bounds the kernel and what its
design does about it.

* :func:`flash_attention_cuda` launches a kernel on CUDA tensors and counts
  its launches in ``flash_attention_cuda.launches``.  Which kernel takes
  which inputs (:func:`kernel_path`): bf16 at hd 64, 128 and 256 goes to
  the tensor-core kernel (TMA + wgmma); bf16 at hd 16 and 32, and f32 at
  every hd, to the CUDA-core kernel.  Any strides on the batch, head and
  position axes, the head dim dense; the tensor-core kernel also needs
  what TMA needs (16-byte aligned bases, strides that are multiples of 16
  bytes) and raises on a view that breaks it.  Nothing falls back.
* :func:`flash_attention_torch` is the same function as one masked softmax
  in f32 plain torch ops.
* :func:`flash_attention` picks by device: the plain twin for CPU tensors
  only; for a CUDA tensor it launches the kernel or raises; for a ``meta``
  tensor it gives the output's shape and nothing else, so that a step can
  be traced without a device (``launch/dryrun.py``).  Any other device
  raises.  The kernel is a forward only (the reference has no backward
  kernel either), so it refuses a CUDA tensor that requires grad while
  grad mode is on; the model trains through the reference's query-chunked
  ``_attend`` (``models/blocks.py``).
* ``torch.ops.repro_torch.flash_attention`` is the same function as one
  registered op: the launcher on CUDA tensors, the twin on CPU tensors, a
  shape-only fake on ``meta``, and a flop formula for
  ``torch.utils.flop_counter``: ``4 B H Tq S hd``, the two products of the
  reference's ``_attend`` over its full (Tq, S) logits, whatever the mask.
  :func:`flash_attention` calls the op where a dispatch mode observes the
  call (a flop counter, a memory tracker, the collective accountant) and on
  ``meta``; otherwise it calls the launcher or the twin directly, since the
  op's dispatcher adds host time to every call on the serving path.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build

HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)       # bf16 on the tensor cores
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_i64 = ctypes.c_int64
_int = ctypes.c_int
_ptr = ctypes.c_void_p


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its launcher's C signature declared."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([_int, _int, _ptr, _ptr, _ptr, _ptr] + [_i64] * 12
                   + [_int] * 7 + [ctypes.c_float, ctypes.c_float, _ptr])
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_wgmma_launch
    fn.argtypes = ([_int, _ptr, _ptr, _ptr, _ptr] + [_i64] * 12
                   + [_int] * 7 + [ctypes.c_float, ctypes.c_float, _ptr])
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int | None, softcap: float | None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Tq, hd) and k, v (B, Hkv, S, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, tq, hd = q.shape
    kb, hkv, s, khd = k.shape
    if kb != b or khd != hd or hkv == 0 or h % hkv != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (same B and hd, H a multiple of Hkv)")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must share one of "
                         f"{list(_DTYPE_CODES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share one device")
    if s == 0:
        raise ValueError("attention over zero keys")
    if causal and tq > s:
        raise ValueError(f"causal attention with Tq={tq} > S={s} leaves "
                         f"query rows with no key")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def kernel_path(dtype: torch.dtype, hd: int) -> str:
    """Which CUDA kernel serves inputs of this type and head dim:
    ``"wgmma"`` (bf16 on the tensor cores) or ``"cuda-core"`` (f32 math)."""
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda-core"


def _tma_strides(t: torch.Tensor) -> list[int]:
    """The (batch, head, position) strides TMA is given for ``t``, after
    checking its rules: a 16-byte aligned base and strides that are
    multiples of 16 bytes.  A stride of an axis of size 1 is never followed,
    so it is replaced by one that passes."""
    if t.data_ptr() % 16:
        raise ValueError(f"the tensor-core kernel reads through TMA, which "
                         f"needs a 16-byte aligned base; got address "
                         f"{t.data_ptr():#x}")
    out = []
    for i in range(3):
        st = t.stride(i) if t.shape[i] > 1 else t.shape[3]
        if (st * t.element_size()) % 16:
            raise ValueError(f"the tensor-core kernel reads through TMA, "
                             f"which needs strides that are multiples of 16 "
                             f"bytes; got stride {t.stride(i)} on axis {i} "
                             f"of a {tuple(t.shape)} {t.dtype} view")
        out.append(st)
    return out


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          softcap: float | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain torch ops: masked softmax attention
    with grouped heads, in f32."""
    _check(q, k, v, causal, window, softcap)
    b, h, tq, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    qg = q.float().reshape(b, hkv, h // hkv, tq, hd)
    logits = torch.einsum("bkgtd,bksd->bkgts", qg, k.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = torch.arange(tq, device=q.device)[:, None] + (s - tq)
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((tq, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", probs, v.float())
    return out.reshape(b, h, tq, hd).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         softcap: float | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel :func:`kernel_path` names on the current
    stream (no synchronisation).

    Returns (B, H, Tq, hd) in q's type: a view of a (B, Tq, H, hd) buffer,
    so the model's ``transpose(1, 2)`` back to token-major is free.  Raises
    if the tensors are not on a CUDA device, hd is not one of
    :data:`HEAD_DIMS`, a view breaks TMA's rules on the tensor-core path,
    the library cannot be built, or the launch reports an error."""
    _check(q, k, v, causal, window, softcap)
    b, h, tq, hd = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel; it takes {HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must be dense along the head dim")
    path = kernel_path(q.dtype, hd)
    if path == "wgmma":
        in_strides = [st for t in (q, k, v) for st in _tma_strides(t)]
    else:
        in_strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    lib = _library()
    out = torch.empty((b, tq, h, hd), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if b == 0 or tq == 0:
        return out
    scale = scale if scale is not None else hd ** -0.5
    strides = in_strides + [out.stride(i) for i in range(3)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        tail = (*strides, b, h, hkv, tq, s, int(causal), window or 0,
                softcap or 0.0, scale, stream)
        if path == "wgmma":
            err = lib.flash_attention_wgmma_launch(hd, *ptrs, *tail)
        else:
            err = lib.flash_attention_launch(_DTYPE_CODES[q.dtype], hd, *ptrs,
                                             *tail)
    if err != 0:
        raise RuntimeError(f"flash_attention {path} kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def _direct(q, k, v, **kw) -> torch.Tensor:
    """The launcher for CUDA tensors, the twin for CPU tensors; any other
    device raises."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, **kw)
    raise ValueError(f"no flash_attention kernel for device {q.device}")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: Optional[int],
                       softcap: Optional[float], scale: Optional[float]
                       ) -> torch.Tensor:
    """The registered op: the launcher on CUDA tensors, the twin on CPU
    tensors (the fake below serves ``meta``)."""
    return _direct(q, k, v, causal=causal, window=window, softcap=softcap,
                   scale=scale)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window, softcap, scale):
    _check(q, k, v, causal, window, softcap)
    b, h, tq, hd = q.shape
    return q.new_empty((b, tq, h, hd)).transpose(1, 2)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def flash_attention_flops(q_shape, k_shape, *args, out_shape=None,
                          **kwargs) -> int:
    """``4 B H Tq S hd``: q k^T and p v over the full (Tq, S) logits, as
    the reference's ``_attend`` computes them under any mask."""
    b, h, tq, hd = q_shape
    return 4 * b * h * tq * k_shape[2] * hd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """The kernel for CUDA tensors, its plain twin for CPU tensors, the
    output's shape for ``meta`` tensors; through the registered op where a
    dispatch mode observes the call."""
    if q.device.type == "cuda":
        _build.check_no_grad("flash_attention", q, k, v)
    if q.device.type == "meta" or _build.observed():
        return flash_attention_op(q, k, v, causal, window, softcap, scale)
    return _direct(q, k, v, causal=causal, window=window, softcap=softcap,
                   scale=scale)
