"""int8 error-feedback gradient compression (port of
``repro.train.compress``).

Quantizing gradients to int8 with per-tensor scales cuts the bytes of a
cross-node reduction 4x against f32; the *error-feedback residual*
re-injects the quantization error on the next step, which keeps SGD/Adam
convergence unbiased (Karimireddy et al., 2019).  On one card there is no
reduction to shrink: the numerics are the wire format's exactly, as in the
reference, and stay plain torch (the reference has no kernel for them).
The residual lives in ``opt_state["residual"]`` (``train/step.py`` threads
it through the step).  Under a mesh the gradients and the residual are
DTensors placed alike: each rank quantizes its own shards with the logical
tensor's scale (its max over the ranks).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.models import act_ctx
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def init_residual(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_decompress(grads: Any, residual: Any) -> tuple[Any, Any]:
    """Returns (dequantized grads, new residual).  Per-tensor symmetric int8."""

    g_leaves, r_leaves = tree_leaves(grads), tree_leaves(residual)
    gs = [act_ctx.local(g).float() + act_ctx.local(r)
          for g, r in zip(g_leaves, r_leaves)]
    amax = act_ctx.reduce_logical(
        g_leaves, torch.stack([torch.max(torch.abs(g)) for g in gs]),
        dist.ReduceOp.MAX)

    def one(g, a):
        scale = torch.clamp(a, min=1e-30) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        dq = q.float() * scale
        return dq, g - dq

    out = [one(g, a) for g, a in zip(gs, amax)]
    return (tree_unflatten(grads, [act_ctx.like(g, o[0])
                                   for g, o in zip(g_leaves, out)]),
            tree_unflatten(grads, [act_ctx.like(r, o[1])
                                   for r, o in zip(r_leaves, out)]))
