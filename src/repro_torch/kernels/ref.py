"""Plain torch oracles for the kernels (port of ``repro.kernels.ref``).

Deliberately *independent* of the code under test: lookup ranks come from a
full searchsorted over the key column, attention from one dense masked
softmax, and the RG-LRU from a sequential loop over time, so a tiling,
masking or scan bug in a kernel path shows up as a mismatch.
``block_rel_err`` is the measure a flash kernel's output is held to beside
the elementwise tolerance, per block of query rows, with its limits.
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


# The most block_rel_err may be for a kernel against its f32 twin.  bf16:
# the tensor-core kernel rounds the probabilities and the output to bf16,
# a few 1e-3 in a block; a window edge off by one key or a dropped key tile
# costs several times the limit in the blocks it touches.  f32: the same
# sums in another order, near 1e-5.
BLOCK_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def block_rel_err(got: torch.Tensor, want: torch.Tensor,
                  rows: int = 64) -> float:
    """Largest relative Frobenius error, ``||got - want|| / ||want||``,
    over the blocks of ``rows`` query rows of one (batch, head) of a
    (B, H, T, hd) attention output.  A fault confined to a few rows or keys
    shows at full strength in its blocks, where a norm over the whole
    tensor or an elementwise bound sized for the largest outputs would
    dilute it."""
    b, h, t, d = want.shape
    pad = -t % rows
    diff = F.pad(got.float() - want.float(), (0, 0, 0, pad))
    ref = F.pad(want.float(), (0, 0, 0, pad))
    blocks = (b, h, (t + pad) // rows, rows * d)
    num = diff.reshape(blocks).norm(dim=-1)
    den = ref.reshape(blocks).norm(dim=-1)
    return float((num / den).max())


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
