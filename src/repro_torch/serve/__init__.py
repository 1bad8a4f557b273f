"""Serving of the port: LM prefill/decode steps and continuous batching, and
the index services (port of ``repro.serve``).

The SLO-driven construction path (``FitSpec`` -> ``open_index`` /
``open_pipeline``), the sharded service, the device-sharded plane, the async
front door, telemetry
and the typed query plane's result types are re-exported from
``repro_torch.index`` so serving code has one import."""
from repro_torch.index.device_plane import (DeviceShardedService,
                                            DeviceShardSet)
from repro_torch.index.fit import FitSpec, IndexPlan, open_index
from repro_torch.index.pipeline import (AsyncIndexService, PipelineClosed,
                                        PipelineOverloaded, open_pipeline)
from repro_torch.index.query import PointResult, RangeResult
from repro_torch.index.sharded import ShardedIndexService, ShardSet, ShardStats
from repro_torch.index.telemetry import (DeviceMetrics, MetricsSnapshot,
                                         Monitor, Replanner, ServiceMetrics)

from .batcher import ContinuousBatcher, Request
from .index_service import IndexService
from .step import make_decode_step, make_prefill_step

__all__ = ["AsyncIndexService", "ContinuousBatcher", "DeviceMetrics",
           "DeviceShardSet", "DeviceShardedService", "FitSpec", "IndexPlan", "IndexService", "MetricsSnapshot",
           "Monitor", "PipelineClosed", "PipelineOverloaded", "PointResult",
           "RangeResult", "Replanner", "Request", "ServiceMetrics",
           "ShardSet", "ShardStats", "ShardedIndexService",
           "make_decode_step", "make_prefill_step", "open_index",
           "open_pipeline"]
