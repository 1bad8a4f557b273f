"""Hand-written Hopper kernels of the port (CUDA C++ sources in ``csrc/``).

fitting_lookup  -- the paper's hot path: the fused route + predict + window
                   + snap search (``fitting_search_cuda``, its plain twin
                   ``fitting_search_torch``, and ``fitting_search``, which
                   picks between them by device), and the window search
                   alone (``fitting_lookup_cuda``, ``fitting_lookup_torch``,
                   ``fitting_lookup_window``)
flash_attention -- blocked online-softmax attention forward: causal, window,
                   softcap, GQA (``flash_attention_cuda``, its twin
                   ``flash_attention_torch``, and the module's
                   ``flash_attention``, which picks by device); the LM's
                   prefill attention
rglru_scan      -- the RG-LRU linear recurrence over time (``rglru_scan_cuda``,
                   its twin ``rglru_scan_torch``, and the module's
                   ``rglru_scan``); the LM's prefill scan.  Two kernels,
                   picked by ``scan_path``: a TMA-fed ring where TMA can
                   read the inputs, one thread a channel elsewhere; and
                   the same two designs run backwards in time for
                   ``RGLRUScan``'s gradient (``rglru_scan_backward``)
shrinking_cone  -- ShrinkingCone (Alg. 2) over many sorted runs in one
                   launch, a warp a run: the re-fit of a shard's dirty
                   segments at publish (``shrinking_cone_runs_cuda``, its
                   twin ``shrinking_cone_runs_torch``, and
                   ``shrinking_cone_runs``, which picks by device)
ops.py          -- the device-index-level wrapper ``ops.fitting_lookup``
ref.py          -- the torch oracles ``lookup_ref``, ``attention_ref``,
                   ``rglru_ref``
"""
from .fitting_lookup import (fitting_lookup_cuda, fitting_lookup_torch,
                             fitting_lookup_window, fitting_search,
                             fitting_search_cuda, fitting_search_torch)
from .flash_attention import flash_attention_cuda, flash_attention_torch
from .ops import LookupPlan, make_lookup_fn, make_plan
from .ref import attention_ref, lookup_ref, rglru_ref
from .rglru_scan import rglru_scan_cuda, rglru_scan_torch
from .shrinking_cone import (shrinking_cone_runs, shrinking_cone_runs_cuda,
                             shrinking_cone_runs_torch)

__all__ = ["LookupPlan", "attention_ref", "fitting_lookup_cuda",
           "fitting_lookup_torch", "fitting_lookup_window", "fitting_search",
           "fitting_search_cuda", "fitting_search_torch",
           "flash_attention_cuda", "flash_attention_torch", "lookup_ref",
           "make_lookup_fn", "make_plan", "rglru_ref", "rglru_scan_cuda",
           "rglru_scan_torch", "shrinking_cone_runs",
           "shrinking_cone_runs_cuda", "shrinking_cone_runs_torch"]
