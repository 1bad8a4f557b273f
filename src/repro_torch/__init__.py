"""FITing-Tree on PyTorch and CUDA: the port of the JAX package ``repro``.

The JAX package stays the reference; this package mirrors its layout and
names (``core/``, ``index/``, ``kernels/``, ``analysis/``) and imports
neither ``jax`` nor anything of ``repro``.  Its kernels are hand-written CUDA
C++ for Hopper (``csrc/``), built with ``nvcc`` at first use.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.

The read path, end to end::

    from repro_torch.index import ServingHandle, Snapshot
    handle = ServingHandle()               # serves on the CUDA card
    handle.install(Snapshot.from_arrays(keys, error=64))
    ranks = handle.search(queries, "left")
"""
from . import analysis, core, index, kernels

__all__ = ["analysis", "core", "index", "kernels"]
