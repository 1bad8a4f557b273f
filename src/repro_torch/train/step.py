"""The train step: loss + grads + AdamW (port of ``repro.train.step``).

Without a mesh it is one device's step.  Under
``activation_sharding(mesh)`` the parameters and the optimizer state are
DTensors (``launch.sharding``), each rank computes the loss of its own rows
and its gradients, which the backward reduces into each leaf's placement
(``act_ctx.materialize``; a weight a tensor-parallel block keeps as its
``model`` shard is reduce-scattered over the data axes only, and a leaf
used on a rank's own heads is also summed over ``model``, by
``act_ctx.placed_like`` where it is replicated), so the loss a rank
differentiates is its mean divided by the data-parallel size; the loss
reported is the global mean.
AdamW then updates each rank's shards in place.

Microbatching (gradient accumulation) is a loop that sums each
microbatch's loss and gradients and scales by ``1 / microbatches``, as the
reference's ``lax.scan``; optional int8 error-feedback gradient
compression (``train/compress.py``) sits between the gradients and the
update.
"""
from __future__ import annotations

import torch

from repro_torch.models import act_ctx, loss_fn
from repro_torch.models.config import ModelConfig

from .compress import compress_decompress
from .optimizer import AdamWConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_unflatten


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, compress: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    batch: {"tokens": (B, T+1) integer[, "memory": (B, M, D)]}, tensors on
    the parameters' device.  metrics: {"loss", "grad_norm", "lr"}, scalar
    tensors.  compress=True enables int8 error-feedback gradient
    compression; the residual is threaded through opt_state["residual"]
    (add it at init via compress.init_residual).  The caller's parameters
    and the state's ``m`` and ``v`` are updated in place (see
    ``optimizer.adamw_update``).  Under a mesh, ``batch`` holds this
    rank's rows."""

    def one(params, tokens, memory):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), cfg, tokens, memory)
        grads = torch.autograd.grad(loss / act_ctx.dp_size(), leaves,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else
                 act_ctx.placed_like(g, p) for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    def grads_of(params, batch):
        tokens, memory = batch["tokens"], batch.get("memory")
        if microbatches == 1:
            loss, grads = one(params, tokens, memory)
            return loss, tree_unflatten(params, grads)
        n = tokens.shape[0] // microbatches
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        acc = [torch.zeros_like(p, dtype=torch.float32)
               for p in tree_leaves(params)]
        for i in range(microbatches):
            rows = slice(i * n, (i + 1) * n)
            with act_ctx.split_batch(microbatches):
                l, g = one(params, tokens[rows],
                           None if memory is None else memory[rows])
            loss = loss + l
            acc = [a + gi for a, gi in zip(acc, g)]
        inv = 1.0 / microbatches
        return loss * inv, tree_unflatten(params, [a * inv for a in acc])

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        if compress:
            grads, new_res = compress_decompress(grads,
                                                 opt_state["residual"])
        params, new_opt, metrics = adamw_update(
            params, grads, {k: v for k, v in opt_state.items()
                            if k != "residual"}, opt_cfg)
        if compress:
            new_opt["residual"] = new_res
        metrics["loss"] = act_ctx.mean_over_ranks(loss)
        return params, new_opt, metrics

    return train_step
