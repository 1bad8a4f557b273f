"""Continuous batching: fixed decode slots, prefill-on-admit, evict-on-done
(port of ``repro.serve.batcher``).

A request arrives with a prompt; when a slot frees up the scheduler prefills
it (at batch 1, into a fresh cache that is then copied into the slot's slice
of the batched caches) and the shared decode step advances every slot one
token per tick.  This is the standard continuous-batching loop (Orca/vLLM)
on top of ``model.prefill`` / ``model.decode_step``.  Unlike the reference,
whose arrays are immutable, the port writes a prefilled slot into the
batched caches in place.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.index.engine import resolve_device
from repro_torch.models import decode_step, init_caches, prefill
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (L,) int32
    max_new: int = 32
    eos: int = -1                # -1: never
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _copy_slot(full, new, s: int) -> None:
    """Write the batch-1 cache tree ``new`` into slot ``s`` of ``full``."""
    if isinstance(full, torch.Tensor):
        full[s: s + 1] = new.to(full.dtype)
    elif isinstance(full, dict):
        for k in full:
            _copy_slot(full[k], new[k], s)
    else:
        for f, n in zip(full, new, strict=True):
            _copy_slot(f, n, s)


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, n_slots: int = 4,
                 cache_len: int = 512, dtype=torch.float32, device=None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"batcher on {self.device}")
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.caches = init_caches(cfg, n_slots, cache_len, dtype=dtype,
                                  device=self.device)
        self.slot_req: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)
        self.queue: deque[Request] = deque()
        self.completed: list[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.popleft()
                self._prefill_slot(s, req)

    def _prefill_slot(self, s: int, req: Request):
        """Prefill one slot: runs the model at batch=1 and writes the slot's
        cache slice (slot caches share the batch dim)."""
        one = init_caches(self.cfg, 1, self.cache_len, dtype=torch.float32,
                          device=self.device)
        tokens = torch.as_tensor(req.prompt[None], dtype=torch.int32,
                                 device=self.device)
        logits, one = prefill(self.params, self.cfg, tokens, one,
                              last_only=True)
        req.out.append(int(logits[0, -1].argmax()))
        _copy_slot(self.caches, one, s)
        self.slot_req[s] = req
        self.slot_pos[s] = req.prompt.shape[0]

    def tick(self):
        """One scheduler tick: admit waiting requests, decode one token for
        every active slot, retire finished requests."""
        self._admit()
        active = [s for s in range(self.n_slots) if self.slot_req[s]]
        if not active:
            return False
        tokens = np.zeros((self.n_slots, 1), np.int32)
        for s in active:
            tokens[s, 0] = self.slot_req[s].out[-1]
        logits, self.caches = decode_step(
            self.params, self.cfg, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(self.slot_pos.copy()).to(self.device),
            self.caches)
        nxt = logits[:, -1].argmax(dim=-1).cpu().numpy()
        for s in active:
            req = self.slot_req[s]
            tok = int(nxt[s])
            req.out.append(tok)
            self.slot_pos[s] += 1
            if (len(req.out) >= req.max_new or tok == req.eos
                    or self.slot_pos[s] >= self.cache_len - 1):
                req.done = True
                self.completed.append(req)
                self.slot_req[s] = None
                self.slot_pos[s] = 0
        return True

    def run_until_drained(self, max_ticks: int = 10_000) -> int:
        ticks = 0
        while (self.queue or any(self.slot_req)) and ticks < max_ticks:
            self.tick()
            ticks += 1
        return ticks
