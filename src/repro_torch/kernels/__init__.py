"""Hand-written Hopper kernels of the port (CUDA C++ sources in ``csrc/``).

fitting_lookup -- the paper's hot path: the bounded-window rank search
                  (``fitting_lookup_cuda``, its plain twin
                  ``fitting_lookup_torch``, and ``fitting_lookup_window``,
                  which picks between them by device)
ops.py         -- the device-index-level wrapper ``ops.fitting_lookup``
ref.py         -- the torch oracle ``lookup_ref``
"""
from .fitting_lookup import (fitting_lookup_cuda, fitting_lookup_torch,
                             fitting_lookup_window)
from .ops import LookupPlan, make_lookup_fn, make_plan
from .ref import lookup_ref

__all__ = ["LookupPlan", "fitting_lookup_cuda", "fitting_lookup_torch",
           "fitting_lookup_window", "lookup_ref", "make_lookup_fn",
           "make_plan"]
