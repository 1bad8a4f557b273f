"""Plain torch oracles for the kernels (port of ``repro.kernels.ref``).

Deliberately *independent* of the code under test: lookup ranks come from a
full searchsorted over the key column, attention from one dense masked
softmax, and the RG-LRU from a sequential loop over time, so a tiling,
masking or scan bug in a kernel path shows up as a mismatch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def lookup_ref(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Global rank of each query in the sorted ``keys``, or -1 if absent."""
    rank = torch.searchsorted(keys, queries, side="left")
    n = keys.shape[0]
    hit = (rank < n) & (keys[rank.clamp(max=n - 1)] == queries)
    return torch.where(hit, rank, -1).to(torch.int32)


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  softcap: float | None = None, scale: float | None = None):
    """Masked multi-head attention oracle.  q,k,v: (B, H, T, D) / (B, H, S, D)."""
    t, s = q.shape[-2], k.shape[-2]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = torch.arange(t, device=q.device)[:, None] + (s - t)   # align ends
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", probs, v.float()).to(q.dtype)


def rglru_ref(x, a_log, gate_x, gate_a):
    """RG-LRU oracle (RecurrentGemma Eq. 1-4), sequential loop over time.

    x, gate_x, gate_a: (B, T, D); a_log: (D,) learned log-decay.
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
    with a_t = exp(-c * softplus(a_log) * sigmoid(gate_a)), i_t = sigmoid(gate_x).
    """
    c = 8.0
    a = torch.exp(-c * F.softplus(a_log)[None, None, :]
                  * torch.sigmoid(gate_a))
    gated = torch.sigmoid(gate_x) * x
    mult = torch.sqrt(torch.clamp(1.0 - a ** 2, min=1e-12)).float()
    u = mult * gated.float()
    a = a.float()
    h = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                    device=x.device)
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + u[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype)
