"""Serve steps: prefill (last-token logits) and greedy decode, cache-threaded
(port of ``repro.serve.step``).

Under ``activation_sharding(mesh)`` the parameters and the caches are
DTensors (``launch.specs.make_step_and_specs`` places them) and the tokens
are this rank's rows.  A cache leaf's batch dim is over the data-parallel
axes, an attention cache's kv heads or length, an RG-LRU or sLSTM state's
channels and the mLSTM's value rows, k entries or heads over ``model``
(``launch.sharding.cache_spec``).  The model hands each block its caches
placed (``models.model``), and each block reads from their placements
which shard of each leaf is its own.  The new caches, this rank's shards,
come back placed as the old ones (``act_ctx.like``).  Under a vocabulary split
over ``model`` the logits are this rank's columns, and the greedy pick
combines the ranks' (``tensor_parallel.argmax``): the tokens are the same
on every model rank.
"""
from __future__ import annotations

import torch

from repro_torch.models import act_ctx, decode_step, prefill, tensor_parallel
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


def _placed_as(old, new):
    return new if act_ctx.mesh() is None else tree_map(act_ctx.like, old, new)


def _greedy(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The last position's argmax over the vocabulary, from the whole
    logits or this rank's columns of them."""
    last = logits[:, -1]
    lo = tensor_parallel.vocab_offset(last.shape[-1], cfg.vocab)
    pick = last.argmax(dim=-1) if lo is None else \
        tensor_parallel.argmax(last, lo)
    return pick.int()


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, caches, memory=None):
        logits, new = prefill(params, cfg, tokens, caches, memory=memory,
                              last_only=True)
        return _greedy(logits, cfg), _placed_as(caches, new)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_fn(params, tokens, pos, caches):
        """tokens: (B,1) current token; pos: (B,) its absolute position."""
        logits, new = decode_step(params, cfg, tokens, pos, caches)
        return _greedy(logits, cfg), _placed_as(caches, new)
    return decode_fn
