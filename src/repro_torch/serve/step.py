"""Serve steps: prefill (last-token logits) and greedy decode, cache-threaded
(port of ``repro.serve.step``).

Under ``activation_sharding(mesh)`` the parameters and the caches are
DTensors (``launch.specs.make_step_and_specs`` places them) and the tokens
are this rank's rows.  A cache leaf's batch dim is over the data-parallel
axes, and an attention cache's kv heads or length over ``model``
(``launch.sharding.cache_spec``).  The model hands each block its caches
(``models.model``): an attention block reads from their placements which
shard of each leaf is its own, a recurrent block takes its rows.  The new
caches, this rank's shards, come back placed as the old ones
(``act_ctx.like``).
"""
from __future__ import annotations

from repro_torch.models import act_ctx, decode_step, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


def _placed_as(old, new):
    return new if act_ctx.mesh() is None else tree_map(act_ctx.like, old, new)


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, caches, memory=None):
        logits, new = prefill(params, cfg, tokens, caches, memory=memory,
                              last_only=True)
        return logits[:, -1].argmax(dim=-1).int(), _placed_as(caches, new)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_fn(params, tokens, pos, caches):
        """tokens: (B,1) current token; pos: (B,) its absolute position."""
        logits, new = decode_step(params, cfg, tokens, pos, caches)
        return logits[:, -1].argmax(dim=-1).int(), _placed_as(caches, new)
    return decode_fn
