"""Serving of the port: LM prefill/decode steps and continuous batching, the
paged KV cache's host bookkeeping, and the index services (port of
``repro.serve``).

The SLO-driven construction path (``FitSpec`` -> ``open_index`` /
``open_pipeline``), the sharded service, the device-sharded plane, the async
front door, telemetry
and the typed query plane's result types are re-exported from
``repro_torch.index`` so serving code has one import.  Every name resolves
on first access (PEP 562), so ``repro_torch.serve.paged_kv``, which is host
numpy, imports without torch."""
import importlib

_EXPORTS = {
    "DeviceShardedService": "repro_torch.index.device_plane",
    "DeviceShardSet": "repro_torch.index.device_plane",
    "FitSpec": "repro_torch.index.fit", "IndexPlan": "repro_torch.index.fit",
    "open_index": "repro_torch.index.fit",
    "AsyncIndexService": "repro_torch.index.pipeline",
    "PipelineClosed": "repro_torch.index.pipeline",
    "PipelineOverloaded": "repro_torch.index.pipeline",
    "open_pipeline": "repro_torch.index.pipeline",
    "PointResult": "repro_torch.index.query",
    "RangeResult": "repro_torch.index.query",
    "ShardedIndexService": "repro_torch.index.sharded",
    "ShardSet": "repro_torch.index.sharded",
    "ShardStats": "repro_torch.index.sharded",
    "DeviceMetrics": "repro_torch.index.telemetry",
    "MetricsSnapshot": "repro_torch.index.telemetry",
    "Monitor": "repro_torch.index.telemetry",
    "Replanner": "repro_torch.index.telemetry",
    "ServiceMetrics": "repro_torch.index.telemetry",
    "ContinuousBatcher": ".batcher", "Request": ".batcher",
    "IndexService": ".index_service",
    "CompressedBlockTable": ".paged_kv", "PagedKVCache": ".paged_kv",
    "compressed_table": ".paged_kv",
    "make_decode_step": ".step", "make_prefill_step": ".step",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name], __name__),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
