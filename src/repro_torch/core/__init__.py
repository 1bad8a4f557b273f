"""FITing-Tree core of the torch port: segmentation, tree, cost model,
datasets, device index.

The host-side modules (segmentation, tree, cost model, datasets) are pure
numpy and imported eagerly; the device-side names from ``torch_index`` resolve lazily (PEP 562)
so host-only code never pulls in torch.
"""
from .segmentation import (Segments, max_segments_bound, optimal_segmentation,
                           shrinking_cone, shrinking_cone_py, verify_segments)
from .tree import FITingTree, PackedRouter
from .cost_model import (CostParams, GPUCostParams, calibrate_device,
                         choose_error_for_latency, choose_error_for_space,
                         dispatch_thresholds, latency_ns, latency_ns_gpu,
                         learn_segments_fn, range_latency_ns,
                         range_latency_ns_gpu, scan_ns_per_row_gpu,
                         size_bytes, tier_cost_curves)
from . import datasets

_TORCH_INDEX_NAMES = {"DeviceIndex", "bound", "build_device_index", "lookup",
                      "predict_positions", "range_count", "rescale_keys"}

__all__ = [
    "Segments", "shrinking_cone", "shrinking_cone_py", "optimal_segmentation",
    "verify_segments", "max_segments_bound", "FITingTree", "PackedRouter",
    "CostParams", "GPUCostParams", "calibrate_device", "latency_ns",
    "latency_ns_gpu", "size_bytes", "learn_segments_fn",
    "choose_error_for_latency", "choose_error_for_space",
    "dispatch_thresholds", "tier_cost_curves", "range_latency_ns",
    "range_latency_ns_gpu", "scan_ns_per_row_gpu", "datasets",
    *sorted(_TORCH_INDEX_NAMES),
]


def __getattr__(name):
    if name in _TORCH_INDEX_NAMES:
        from . import torch_index
        return getattr(torch_index, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
