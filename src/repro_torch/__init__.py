"""FITing-Tree on PyTorch and CUDA: the port of the JAX package ``repro``.

The JAX package stays the reference; this package mirrors its layout and
names (``core/``, ``index/``, ``kernels/``, ``analysis/``, and for the LM
substrate ``models/``, ``configs/``, ``serve/``, ``train/``,
``checkpoint/``, ``data/``, ``launch/``) and imports neither ``jax``
nor anything of ``repro``.  Its kernels are hand-written CUDA C++ for Hopper
(``csrc/``: ``fitting_lookup``, ``flash_attention``, ``rglru_scan``), built
with ``nvcc`` at first use.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.  The subpackages resolve on first access
(PEP 562), so importing a host-only module (``core.tree``,
``core.cost_model``, ``index.table``, ``index.query``, ``index.telemetry``)
loads no ``torch``.

The read path, end to end::

    from repro_torch.index import ServingHandle, Snapshot
    handle = ServingHandle()               # serves on the CUDA card
    handle.install(Snapshot.from_arrays(keys, error=64))
    ranks = handle.search(queries, "left")

The write path, planned and sharded (Alg. 4 inserts, per-shard epochs)::

    from repro_torch.serve import FitSpec, IndexService, open_index
    svc = IndexService(keys, error=64, buffer_size=16)   # on the CUDA card
    svc.insert(k); svc.publish(); svc.search(queries)
    svc = open_index(keys, FitSpec(latency_budget_ns=90_000.0,
                                   hardware="gpu", insert_rate=65_536.0))

RecurrentGemma-9B serving (prefill on the flash-attention and RG-LRU
kernels, greedy decode over ring caches)::

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ContinuousBatcher, Request
    cfg = get_config("recurrentgemma-9b")
    batcher = ContinuousBatcher(cfg, init_params(cfg, seed=0), n_slots=4,
                                cache_len=4160)
    batcher.submit(Request(0, prompt, max_new=16))
    batcher.run_until_drained()

Training on one card (AdamW, checkpoints, the learned-index data
pipeline; ``--device cpu`` on a machine without one)::

    python -m repro_torch.launch.train --arch internlm2-1.8b --steps 100 \
        --ckpt-dir /tmp/ckpt --resume
"""
import importlib

__all__ = ["analysis", "checkpoint", "configs", "core", "data", "index",
           "kernels", "launch", "models", "serve", "train"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
