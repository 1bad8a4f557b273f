"""Build and load the port's CUDA kernels: ``nvcc`` by hand into a shared
library with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles at first use into
``_build/<name>-<hash>.so`` inside this package (a directory that
``.gitignore`` lists, so a build never writes outside the package), keyed by a hash of the source and the flags, so a
changed source rebuilds and an unchanged one loads at once.  ``ptxas``'s
report (registers, spills) is kept beside it as ``<name>-<hash>.log``.  A
missing ``nvcc`` or a failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    ``PATH``, else :data:`DEFAULT_NVCC`."""
    cands = [Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), DEFAULT_NVCC]
    for cand in cands:
        if cand is not None and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (the path depends on its hash)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or none
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, loaded once per process."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build(name)))
                _LIBS[name] = lib
    return lib


def observed() -> bool:
    """Whether a ``TorchDispatchMode`` is active (a flop counter, a memory
    tracker, the collective accountant, fake tensors): a kernel wrapper
    then calls its registered op, which such a mode sees whole, instead of
    its launcher, which it would not see at all."""
    return torch._C._len_torch_dispatch_stack() > 0


def check_no_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and a CUDA tensor among ``tensors``
    requires a gradient: a kernel wrapper that fills its output through
    ``ctypes`` gives it no ``grad_fn``, so autograd would silently drop
    the gradient of everything upstream."""
    if not torch.is_grad_enabled():
        return
    if any(t is not None and t.device.type == "cuda" and t.requires_grad
           for t in tensors):
        raise RuntimeError(
            f"{name} got a CUDA tensor that requires grad with grad mode "
            f"on; its kernel has no autograd, so the gradient would be "
            f"dropped (call it under torch.no_grad(), or use the "
            f"differentiable path)")
