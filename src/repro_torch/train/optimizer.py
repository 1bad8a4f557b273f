"""AdamW + LR schedules (port of ``repro.train.optimizer``).

State is a dict {m, v, step}: m and v are f32 trees shaped like the
parameters, step an int32 scalar tensor.  Schedules include WSD
(warmup-stable-decay, the MiniCPM paper's schedule) and cosine.  The
arithmetic is the reference's, per leaf and in its order, in f32 scalar
tensors where the reference computes in f32 arrays, so that one update
rounds as the reference's does; each parameter comes out in its own type.
Updates run under ``torch.no_grad`` and write the parameters, ``m`` and
``v`` in place, as the reference's trainer donates their buffers.  Under a
mesh they are DTensors: each rank updates its own shards, and the norm is
the logical gradient's (``act_ctx.reduce_logical``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models import act_ctx
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"          # "cosine" | "wsd" | "const"
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1           # WSD: fraction of steps in decay phase


def schedule_fn(c: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (an integer tensor) -> the learning rate, an f32 scalar."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = torch.clamp(s / max(c.warmup_steps, 1), max=1.0)
        if c.schedule == "const":
            return c.lr * warm
        if c.schedule == "cosine":
            t = torch.clamp((s - c.warmup_steps)
                            / max(c.total_steps - c.warmup_steps, 1), 0, 1)
            return c.lr * warm * (0.5 * (1 + torch.cos(math.pi * t)))
        if c.schedule == "wsd":
            # warmup -> stable at lr -> linear decay in the final fraction
            decay_start = c.total_steps * (1.0 - c.decay_frac)
            t = torch.clamp((s - decay_start)
                            / max(c.total_steps - decay_start, 1), 0, 1)
            return c.lr * warm * (1.0 - t * (1.0 - 0.1))
        raise ValueError(c.schedule)
    return fn


def init_opt_state(params: Any) -> dict:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


_NORM_CHUNK = 1 << 24


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    """The norm of the logical tree: over DTensor leaves, each rank sums
    the squares of the shards it counts (one replica of each) and the sums
    are reduced over the ranks.  The squares are summed in f64, so that
    the norm, and the clip scale made from it, do not depend on how the
    leaves are sharded (f32 sums in another order round otherwise)."""
    leaves = tree_leaves(tree)
    dev = act_ctx.local(leaves[0]).device
    sq = torch.zeros((), dtype=torch.float64, device=dev)
    for leaf in leaves:
        if act_ctx.counts_once(leaf):
            # a chunk at a time: the f64 sum casts its input
            for c in torch.square(act_ctx.local(leaf).float()).reshape(
                    -1).split(_NORM_CHUNK):
                sq = sq + torch.sum(c, dtype=torch.float64)
    return torch.sqrt(act_ctx.reduce_logical(leaves, sq)).float()


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, c: AdamWConfig):
    """Returns (params, new_state, metrics).  ``params`` and the state's
    ``m`` and ``v`` are updated in place (the reference's trainer donates
    those buffers to the same effect); ``grads`` are left as they were."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(c.grad_clip / (gnorm + 1e-9), max=1.0) \
        if c.grad_clip else torch.ones((), device=gnorm.device)
    lr = schedule_fn(c)(step)
    b1c = 1.0 - torch.pow(c.b1, step.float())
    b2c = 1.0 - torch.pow(c.b2, step.float())

    local = act_ctx.local
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        p, g, m, v = local(p), local(g), local(m), local(v)
        g = g.float() * scale
        m.mul_(c.b1).add_((1 - c.b1) * g)
        v.mul_(c.b2).add_((1 - c.b2) * g * g)
        p32 = p.float()                  # p itself when p is f32
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(c.eps)) \
            .add_(c.weight_decay * p32).mul_(lr)
        if p32 is p:
            p.sub_(upd)
        else:
            p.copy_(p32.sub_(upd))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
