"""FLOP counting of a step, traced on meta tensors (port of
``repro.launch.flops_count``).

The reference counts the products of a step's jaxpr: dot_general and conv
FLOPs, scan bodies times their length, remat's recomputation included.
The port runs its steps eagerly, so it counts what they dispatch:
:func:`count_flops` runs the step once under
``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
convolutions, ``2 m n k`` each, backward ones included).  The kernels count
by their registered formulas: ``repro_torch::flash_attention`` as the
reference's dense ``_attend`` (``4 B H Tq S hd``, whatever the mask) and
``repro_torch::rglru_scan`` as 0 (no products).  On meta tensors nothing is
allocated or computed, and the count is the same as on the CPU or the
card, since it depends on shapes alone.

Two quantities, as the dry-run records them:

* ``jaxpr_flops_global`` (:func:`flops_global`) keeps the reference's
  meaning, the global program's products, remat's recomputation included:
  the same step traced without a mesh at the global shapes.
* ``cost.flops`` is one rank's count on the mesh, the per-device count
  that the reference's ``cost_analysis`` gives.  It is one rank's trace:
  its batch is the rank's rows, and the attention, MLP, RG-LRU and xLSTM
  products and the unembedding are its ``model`` share
  (``models/tensor_parallel.py``; where the q heads do not divide, the
  rank's columns of the projections and flash over the heads they touch);
  the products the port still computes whole on every ``model`` rank (k /
  v where the kv heads do not divide but the q heads do, a vocabulary
  ``model`` does not divide, the sLSTM's ``up`` / ``down`` where ``model``
  does not divide their width) repeat there.
"""
from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode

from . import specs


def count_flops(step, *args, **kwargs) -> int:
    """The matrix-product FLOPs of one call of ``step(*args, **kwargs)``."""
    with FlopCounterMode(display=False) as counter:
        step(*args, **kwargs)
    return counter.get_total_flops()


def flops_global(arch, shape, *, microbatches: int = 1) -> int:
    """``jaxpr_flops_global``: the cell's step without a mesh at its global
    shapes, on meta."""
    step, args, _, _, _ = specs.make_step_and_specs(
        arch, shape, None, microbatches=microbatches)
    return count_flops(step, *args)
