"""Serve steps: prefill (last-token logits) and greedy decode, cache-threaded
(port of ``repro.serve.step``)."""
from __future__ import annotations

from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, caches, memory=None):
        logits, caches = prefill(params, cfg, tokens, caches, memory=memory,
                                 last_only=True)
        return logits[:, -1].argmax(dim=-1).int(), caches
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_fn(params, tokens, pos, caches):
        """tokens: (B,1) current token; pos: (B,) its absolute position."""
        logits, caches = decode_step(params, cfg, tokens, pos, caches)
        return logits[:, -1].argmax(dim=-1).int(), caches
    return decode_fn
