"""ShrinkingCone (FITing-Tree Alg. 2) over many sorted runs at once: the
re-fit of a shard's dirty segments at publish, hand-written in CUDA for
Hopper, and its plain twin.

Replaces no TPU kernel: the JAX package fits on the host in numpy
(``src/repro/core/segmentation.py`` ``shrinking_cone``).  A publish re-fits
hundreds of short runs a shard, and one Python ``shrinking_cone`` call a
run costs far more than the keys do; :func:`shrinking_cone_runs_cuda`
fits all of them in one launch, one warp a run (``csrc/shrinking_cone.cu``
states what bounds it and what its design does about it).

Runs are given as one flat f64 key tensor, each run ascending, and their
bounds ``offsets`` (``n_runs + 1`` ascending host integers from 0 to the
key count, every run non-empty).  Each entry returns ``(is_start,
slope)``: ``is_start`` one uint8 a key, 1 where a segment starts (every
run's first key does), and in ``mode="clamped"`` ``slope`` one f64 a key,
the segment's clamped slope at each start (0 elsewhere); None in
``mode="paper"``, whose slopes ``_finalize`` computes from the starts.
Both equal :func:`repro_torch.core.segmentation.shrinking_cone` run by
run, bit for bit.

:func:`shrinking_cone_runs_torch` is the twin: ``shrinking_cone`` looped
over the runs.  :func:`shrinking_cone_runs` takes the twin for CPU tensors,
launches the kernel for CUDA tensors and raises on anything else.
``shrinking_cone_runs_cuda.launches`` counts the launches, under a lock.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from repro_torch.core.segmentation import shrinking_cone

from . import _build

_i64 = ctypes.c_int64
_ptr = ctypes.c_void_p
_COUNT_LOCK = threading.Lock()
MODES = ("paper", "clamped")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its launcher's C signature declared."""
    lib = _build.load("shrinking_cone")
    fn = lib.shrinking_cone_launch
    fn.argtypes = [_ptr, _ptr, _i64, ctypes.c_double, ctypes.c_int, _ptr,
                   _ptr, _ptr]
    fn.restype = ctypes.c_int
    return lib


def load_library(device: torch.device) -> None:
    """Build (or load the cached build of) the kernel's library ahead of
    fits on ``device`` where that is a CUDA card and one is present, so no
    fit pays the build; nothing otherwise (a fit on a CUDA device without a
    card raises there)."""
    if device.type == "cuda" and torch.cuda.is_available():
        _library()


def _check(keys: torch.Tensor, offsets, error: int, mode: str) -> np.ndarray:
    """Validate the inputs; the offsets as a host int64 array."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if keys.dim() != 1 or keys.dtype != torch.float64 or \
            not keys.is_contiguous():
        raise ValueError(f"keys must be a contiguous 1-D float64 tensor, "
                         f"got {tuple(keys.shape)} {keys.dtype}")
    off = np.asarray(offsets)
    if off.ndim != 1 or off.shape[0] < 1 or \
            not np.issubdtype(off.dtype, np.integer):
        raise ValueError(f"offsets must be a 1-D integer array of n_runs + 1 "
                         f"bounds, got {off.shape} {off.dtype}")
    off = off.astype(np.int64)
    if off[0] != 0 or off[-1] != keys.shape[0] or np.any(np.diff(off) <= 0):
        raise ValueError(f"offsets must rise strictly from 0 to the key "
                         f"count {keys.shape[0]} (every run non-empty)")
    if error < 0:
        raise ValueError(f"error must be >= 0, got {error}")
    return off


def shrinking_cone_runs_torch(keys: torch.Tensor, offsets, error: int,
                              mode: str = "paper"
                              ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The kernel's function on the host: ``shrinking_cone`` run by run."""
    off = _check(keys, offsets, error, mode)
    xs = keys.numpy()
    is_start = np.zeros(xs.shape[0], np.uint8)
    slope = np.zeros(xs.shape[0], np.float64) if mode == "clamped" else None
    for a, b in zip(off[:-1].tolist(), off[1:].tolist()):
        segs = shrinking_cone(xs[a:b], error, mode=mode)
        at = a + segs.base
        is_start[at] = 1
        if slope is not None:
            slope[at] = segs.slope
    return (torch.from_numpy(is_start),
            None if slope is None else torch.from_numpy(slope))


def shrinking_cone_runs_cuda(keys: torch.Tensor, offsets, error: int,
                             mode: str = "paper"
                             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the kernel on the current stream (no synchronisation): the
    outputs lie on the keys' card.  Raises if the keys are not on a CUDA
    device, the library cannot be built, or the launch reports an error."""
    off = _check(keys, offsets, error, mode)
    if keys.device.type != "cuda":
        raise ValueError(f"shrinking_cone_runs_cuda needs a CUDA tensor, got "
                         f"{keys.device}")
    dev = keys.device
    n, n_runs = keys.shape[0], off.shape[0] - 1
    is_start = torch.zeros(n, dtype=torch.uint8, device=dev)
    slope = (torch.zeros(n, dtype=torch.float64, device=dev)
             if mode == "clamped" else None)
    if n_runs == 0:
        return is_start, slope
    off_dev = torch.from_numpy(off).to(dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.shrinking_cone_launch(
            keys.data_ptr(), off_dev.data_ptr(), n_runs, float(error),
            int(mode == "clamped"), is_start.data_ptr(),
            None if slope is None else slope.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"shrinking_cone kernel launch failed: CUDA error "
                           f"{err}")
    with _COUNT_LOCK:
        shrinking_cone_runs_cuda.launches += 1
    return is_start, slope


shrinking_cone_runs_cuda.launches = 0


def shrinking_cone_runs(keys: torch.Tensor, offsets, error: int,
                        mode: str = "paper"
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The kernel for CUDA tensors, its plain twin for CPU tensors."""
    if keys.device.type == "cuda":
        return shrinking_cone_runs_cuda(keys, offsets, error, mode)
    if keys.device.type == "cpu":
        return shrinking_cone_runs_torch(keys, offsets, error, mode)
    raise ValueError(f"no shrinking_cone kernel for device {keys.device}")
