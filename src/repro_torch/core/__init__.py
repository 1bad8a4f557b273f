"""FITing-Tree core of the torch port: segmentation, datasets, device index.

The host-side modules (segmentation, datasets) are pure numpy and imported
eagerly; the device-side names from ``torch_index`` resolve lazily (PEP 562)
so host-only code never pulls in torch.
"""
from .segmentation import (Segments, max_segments_bound, optimal_segmentation,
                           shrinking_cone, shrinking_cone_py, verify_segments)
from . import datasets

_TORCH_INDEX_NAMES = {"DeviceIndex", "bound", "build_device_index", "lookup",
                      "predict_positions", "range_count", "rescale_keys"}

__all__ = [
    "Segments", "shrinking_cone", "shrinking_cone_py", "optimal_segmentation",
    "verify_segments", "max_segments_bound", "datasets",
    *sorted(_TORCH_INDEX_NAMES),
]


def __getattr__(name):
    if name in _TORCH_INDEX_NAMES:
        from . import torch_index
        return getattr(torch_index, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
