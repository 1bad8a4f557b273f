"""Model blocks of the port (functional: explicit parameter dicts), for
every block type: self-attention (``attn``, ``local``, ``enc``, with
optional qk-norm), cross-attention (``cross`` and the cross half of
``self+cross``), the top-k MoE FFN, the RG-LRU and the xLSTM pair (``mlstm``,
``slstm``) (port of ``repro.models.blocks``).

Every block follows ``apply_<x>(params, x, cfg, ctx) -> (x, new_cache)``
where ``ctx`` carries mode/positions/memory/cache.  Caches make
prefill/decode work: KV rings for self-attention (global cache = ring of
size S, local = ring of size window), the memory's keys and values for
cross-attention, recurrent states for the RG-LRU and the xLSTM blocks.

The two hot functions of prefill run on the port's hand-written kernels:
attention over the prompt (self- or cross-) is ``kernels.flash_attention``
(the reference computes the same function in XLA, ``_attend`` under the
prefill mask), and the RG-LRU scan is ``kernels.rglru_scan.RGLRUScan`` (the
reference's associative ``_rglru_scan`` and its custom VJP), whose backward
launches the same kernel.  Flash is a forward only, as in the reference, so
attention that autograd must differentiate (training) takes the reference's
query-chunked ``_attend`` in torch ops.  Decode attention, the one-step
RG-LRU update, the MoE dispatch and the xLSTM recurrences stay plain torch,
as the reference keeps them in XLA (a Python loop stands for ``lax.scan``).

Under a mesh every block takes its parameters as the model holds them
(DTensors) and gathers them itself: each keeps the ``model`` shard of the
weights it splits over that axis (the MLP's hidden units, attention's heads
or columns by :func:`attention_heads`, MoE's experts, the RG-LRU's and the sLSTM's
channels, the mLSTM's columns by :func:`_mlstm_parts`) and combines its
partial outputs over ``model`` (``tensor_parallel``).  Each takes its
caches placed too, and reads from their placements which share of each
leaf is its own.

Types follow JAX's promotion: :func:`mm` multiplies mixed-type operands in
the wider type (f32 caches meet bf16 weights at decode), and elementwise ops
promote as torch does for tensors of one kind, which is the same rule.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import RGLRUScan

from . import act_ctx, tensor_parallel
from .config import ModelConfig

# make(shape, dtype) -> a new N(0, 0.02) parameter; init_params supplies it
Dense = Callable[[tuple, torch.dtype], torch.Tensor]


@dataclasses.dataclass
class Ctx:
    mode: str                          # "train" | "prefill" | "decode"
    pos: torch.Tensor | None = None    # (B, T) absolute positions
    memory: torch.Tensor | None = None  # (B, M, D) cross-attention source
    cache: Any = None                  # per-layer cache dict (prefill/decode)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion: mixed operands (an f32 cache
    read against bf16 weights) multiply in the wider type; like types keep
    theirs (bf16 x bf16 -> bf16, accumulated in f32 by the matmul).  Batched
    operands (the experts' ``(E, C, D) @ (E, D, F)``) promote the same way."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, hd), pos: (B, T) -> rotated (angles in f32, cast back)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = pos[..., None].float() * freqs                  # (B, T, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------- attn
def init_attention(cfg: ModelConfig, dense: Dense, dtype: torch.dtype,
                   device) -> dict:
    """Self- and cross-attention share one layout."""
    d, hd, h, kv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": dense((d, h * hd), dtype), "wk": dense((d, kv * hd), dtype),
         "wv": dense((d, kv * hd), dtype), "wo": dense((h * hd, d), dtype)}
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=dtype, device=device)
    return p


Q_CHUNK = 512  # memory-efficient attention: peak logits = B*H*Q_CHUNK*S


def _attend_dense(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """q: (B,T,H,hd); k,v: (B,S,Kv,hd); mask: (B,T,S) or (T,S). GQA-grouped.

    The plain path: decode over the ring cache, and each query chunk of
    :func:`_attend`."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    q = q.reshape(b, t, kv, g, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", q.float(),
                          k.float()) * (cfg.hd ** -0.5)
    if cfg.attn_softcap is not None:
        logits = torch.tanh(logits / cfg.attn_softcap) * cfg.attn_softcap
    m = mask if mask.dim() == 3 else mask[None]
    logits = torch.where(m[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(b, t, h * hd).to(v.dtype)


def _attend(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """Query-chunked attention, the reference's ``_attend``: the training
    path, which autograd differentiates.  O(Q_CHUNK * S) logits live at
    once instead of O(T * S); each chunk runs under
    ``torch.utils.checkpoint``, as the reference's under ``jax.checkpoint``,
    so backward recomputes the (chunk x S) probabilities instead of keeping
    every chunk's."""
    t = q.shape[1]
    if t <= Q_CHUNK or t % Q_CHUNK != 0:
        return _attend_dense(q, k, v, mask, cfg)
    outs = []
    for i in range(t // Q_CHUNK):
        rows = slice(i * Q_CHUNK, (i + 1) * Q_CHUNK)
        m = mask[:, rows] if mask.dim() == 3 else mask[rows]
        outs.append(checkpoint(_attend_dense, q[:, rows], k, v, m, cfg,
                               use_reentrant=False))
    return torch.cat(outs, dim=1)


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd must differentiate through attention over these."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _train_mask(t: int, causal: bool, window: Optional[int],
                device) -> torch.Tensor:
    """The reference's (T, T) train/prefill mask over positions 0..T-1."""
    ar = torch.arange(t, dtype=torch.int32, device=device)
    qp, kp = ar[:, None], ar[None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


def _attend_prefill(q, k, v, cfg: ModelConfig, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """The reference's ``_attend`` under the prefill mask (positions
    0..T-1 for queries and keys alike) is ``flash_attention`` with
    q_offset = 0, and under cross-attention's all-ones mask it is the
    kernel with ``causal=False`` (q_offset = S - T, which then masks
    nothing): the kernel on the card, its plain twin on the CPU.

    The kernel takes one type; the reference computes in f32 whatever it
    is given and returns v's type.  So mixed operands (a bf16 decoder query
    over keys projected from f32 memory) meet in the wider type, and the
    result is cast to v's."""
    b, t, h, hd = q.shape
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    out = flash_attention(q.transpose(1, 2).to(dt), k.transpose(1, 2).to(dt),
                          v.transpose(1, 2).to(dt), causal=causal,
                          window=window, softcap=cfg.attn_softcap,
                          scale=cfg.hd ** -0.5)
    return out.transpose(1, 2).reshape(b, t, h * hd).to(v.dtype)


@dataclasses.dataclass(frozen=True)
class Heads:
    """The heads one rank computes: q heads ``[q0, q0 + nq)`` and kv heads
    ``[k0, k0 + nk)``.  ``split``: the q heads are split over ``model``, so
    the block's output projection is row-parallel and its result a partial
    sum."""
    q0: int
    nq: int
    k0: int
    nk: int
    split: bool

    def columns(self, hd: int) -> tuple[int, int]:
        """This rank's columns of attention's ``H hd`` outputs, which meet
        its rows of ``wo``: its q heads'."""
        return self.q0 * hd, (self.q0 + self.nq) * hd


@dataclasses.dataclass(frozen=True)
class Columns(Heads):
    """Case C: the rank holds q's columns ``[c0, c0 + nc)`` of ``H hd`` and
    k's and v's ``[kc0, kc0 + nkc)`` of ``Hkv hd``, as ``param_spec`` splits
    ``wq`` / ``wk`` / ``wv`` inside a head.  It computes whole the q heads
    ``[q0, q0 + nq)`` those columns touch and the kv heads ``[k0, k0 +
    nk)`` they group into, after a halo exchange of the columns it lacks
    (:func:`_halo`), and keeps its own output columns."""
    c0: int = 0
    nc: int = 0
    kc0: int = 0
    nkc: int = 0

    def columns(self, hd: int) -> tuple[int, int]:
        return self.c0, self.c0 + self.nc


def attention_heads(p: dict, cfg: ModelConfig) -> Heads:
    """How an attention block with parameters ``p`` (as the model holds
    them) splits its heads over ``model`` (``tensor_parallel``), in the
    reference's ``2d`` / ``tp`` placements, read from those of ``wq``,
    ``wo``, ``wk`` and ``wv``:

    * A, ``H`` and ``Hkv`` divide over the ``tp`` ranks: each computes its
      ``H / tp`` q and ``Hkv / tp`` kv heads (``wq`` / ``wk`` / ``wv``
      column-parallel, ``wo`` row-parallel);
    * B, ``H`` divides and ``Hkv`` does not: the q heads split as in A, and
      every rank computes every kv head (``wk`` and ``wv``, which the rule
      splits inside a head, gathered);
    * C, ``H`` does not divide, and the rule splits ``wq`` / ``wk`` /
      ``wv`` by columns inside a head and ``wo`` by rows: each rank keeps
      its columns (:class:`Columns`), exchanges the halo of the heads they
      touch, computes those heads whole and keeps its own output columns,
      as GSPMD splits those columns.

    Without tensor parallelism, or where the rule leaves the weights whole,
    every head is the rank's."""
    tp = tensor_parallel.size()
    if tp == 1:
        return _heads(cfg.n_heads, cfg.n_kv_heads, cfg.hd, 1, 0, False,
                      False)
    dim = act_ctx.model_split_dim
    return _heads(cfg.n_heads, cfg.n_kv_heads, cfg.hd, tp,
                  tensor_parallel.rank(),
                  dim(p["wq"]) == 1 and dim(p["wo"]) == 0,
                  dim(p["wk"]) == 1 and dim(p["wv"]) == 1)


@functools.lru_cache(maxsize=None)
def _heads(h: int, kv: int, hd: int, tp: int, r: int, q_split: bool,
           kv_split: bool) -> Heads:
    if not q_split or (h % tp and not kv_split):
        return Heads(0, h, 0, kv, False)
    if h % tp:
        nc, nkc = h * hd // tp, kv * hd // tp
        q0, q1 = r * nc // hd, ((r + 1) * nc - 1) // hd + 1
        g = h // kv
        k0 = q0 // g
        return Columns(q0, q1 - q0, k0, (q1 - 1) // g + 1 - k0, True,
                       r * nc, nc, r * nkc, nkc)
    nq = h // tp
    if kv_split and kv % tp == 0:
        return Heads(r * nq, nq, r * (kv // tp), kv // tp, True)
    return Heads(r * nq, nq, 0, kv, True)


@functools.lru_cache(maxsize=None)
def _halo_layouts(h: int, kv: int, hd: int, tp: int, kv_side: bool):
    """Case C's halo as ``tensor_parallel.relayout`` layouts over every
    model rank, one row of ``H hd`` (``Hkv hd``) columns: (each rank's own
    columns, the columns of the q heads it touches or of the kv heads
    those group into, the width)."""
    ranks = [_heads(h, kv, hd, tp, r, True, True) for r in range(tp)]
    if kv_side:
        return (tuple((0, 1, c.kc0, c.nkc) for c in ranks),
                tuple((0, 1, c.k0 * hd, c.nk * hd) for c in ranks), kv * hd)
    return (tuple((0, 1, c.c0, c.nc) for c in ranks),
            tuple((0, 1, c.q0 * hd, c.nq * hd) for c in ranks), h * hd)


def _halo(y: torch.Tensor, cfg: ModelConfig, kv_side: bool = False
          ) -> torch.Tensor:
    """Case C: ``y`` ``(B, S, c)``, this rank's columns of q (``kv_side``:
    of k or v), as ``(B, S, n hd)``, the whole heads its q columns touch
    (the kv heads those group into): each column it lacks from the rank
    that holds it, one all-to-all over ``model`` under autograd, whose
    backward sums each column's gradients into its owner's."""
    src, dst, width = _halo_layouts(cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                    tensor_parallel.size(), kv_side)
    return tensor_parallel.relayout(y, src, dst, width, dim=-1)


def _own_columns(att: torch.Tensor, heads: Heads, hd: int, first: int = 0
                 ) -> torch.Tensor:
    """Of ``att`` ``(B, T, n hd)``, attention's output over heads from
    ``first`` on, this rank's columns (:meth:`Heads.columns`)."""
    lo, hi = heads.columns(hd)
    lo, hi = lo - first * hd, hi - first * hd
    return att if (lo, hi) == (0, att.shape[-1]) else att[..., lo:hi]


def _attention_params(p: dict, heads: Heads, cfg: ModelConfig) -> dict:
    """``p`` as local tensors for ``heads``: the split weights keep their
    ``model`` shard; ``wk`` / ``wv`` gathered where every kv head is
    computed, and with ``q_norm`` / ``k_norm`` their gradient summed over
    ``model`` (each rank back-propagates through its own q heads, or in
    case C its own output columns, only)."""
    if not heads.split:
        return act_ctx.materialize(p)
    if isinstance(heads, Columns):
        return tensor_parallel.shards(p, keep=("wq", "wk", "wv", "wo"),
                                      partial=("q_norm", "k_norm"))
    keep = ("wq", "wo") + (("wk", "wv") if heads.nk < cfg.n_kv_heads
                           else ())
    return tensor_parallel.shards(p, keep=keep,
                                  partial=("wk", "wv", "q_norm", "k_norm"))


def _kv_for(k, v, heads: Heads, cfg: ModelConfig):
    """Of k, v ``(B, S, nk, hd)`` holding kv heads ``[k0, k0 + nk)``, the
    heads that q heads ``[q0, q0 + nq)`` group into, in the grouping
    ``_attend_dense`` and flash read (q head ``j`` over kv head ``j // (nq /
    kv)``): a slice where the q heads split evenly over them, else one kv
    head for each q head (case C's heads that straddle a group's edge)."""
    g = cfg.n_heads // cfg.n_kv_heads
    lo, hi = heads.q0 // g, (heads.q0 + heads.nq - 1) // g + 1
    aligned = hi - lo == 1 or (heads.q0 % g == 0 and heads.nq % g == 0)
    if (lo, hi) == (heads.k0, heads.k0 + heads.nk) and aligned:
        return k, v
    if aligned:
        sl = slice(lo - heads.k0, hi - heads.k0)
        return k[:, :, sl], v[:, :, sl]
    idx = torch.arange(heads.q0, heads.q0 + heads.nq, device=k.device) // g
    return k[:, :, idx - heads.k0], v[:, :, idx - heads.k0]


def _whole_kv(heads: Heads, cfg: ModelConfig) -> Heads:
    """``heads`` over a cache holding every kv head (case C's)."""
    return dataclasses.replace(heads, k0=0, nk=cfg.n_kv_heads)


def _project_out(att: torch.Tensor, wo: torch.Tensor, heads: Heads
                 ) -> torch.Tensor:
    """``att @ wo``; summed over ``model`` where the heads are split."""
    out = mm(att, wo)
    return tensor_parallel.reduce(out) if heads.split else out


def _local_cache(cache: dict, heads: Heads, cfg: ModelConfig):
    """``cache`` as this rank's shard of each leaf: (the local leaves, the
    ring's whole length, where this rank's share of k / v begins along it,
    where its share of pos begins; None where not split by length).

    Under tensor parallelism the leaves come placed (DTensors, by
    ``launch.sharding.cache_spec``), and their placements say which share
    is this rank's: the kv heads (dim 2) exactly where the block computes
    its own (case A), else the length (dim 1) where it divides."""
    if tensor_parallel.size() == 1:
        local = {k: act_ctx.local(v) for k, v in cache.items()}
        return local, local["k"].shape[1], None, None
    if not isinstance(cache["k"], DTensor):
        raise ValueError("under tensor parallelism attention takes its "
                         "caches placed (DTensors), not their local shards")
    dims = {k: act_ctx.model_split_dim(v) for k, v in cache.items()}
    by_heads = heads.nk < cfg.n_kv_heads and not isinstance(heads, Columns)
    if (dims["k"] == 2) != by_heads:
        raise ValueError(f"a cache split over 'model' on {dims} does not "
                         f"fit attention computing kv heads [{heads.k0}, "
                         f"{heads.k0 + heads.nk}) of {cfg.n_kv_heads}")
    local = {k: act_ctx.local(v) for k, v in cache.items()}
    r, n = tensor_parallel.rank(), local["k"].shape[1]
    lo_k = r * n if dims["k"] == 1 else None
    lo_pos = r * local["pos"].shape[1] if dims.get("pos") == 1 else None
    return local, n if lo_k is None else n * tensor_parallel.size(), \
        lo_k, lo_pos


def _whole_positions(cpos: torch.Tensor) -> torch.Tensor:
    """The ring's positions gathered over ``model``: the mask of a ring
    whose k and v are split by heads reads every slot's position, and the
    ``pos`` leaf is split by length (``cache_spec``)."""
    return tensor_parallel.all_gather(cpos, 1)


def _attend_split_ring(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """Decode attention over keys whose slots (a ring's, or the memory's
    positions) are split by length over ``model``: this rank holds its share
    of them for every kv head, and ``q`` holds every q head (the caller
    gathers them: ``B T H hd`` activations, never ``wq``).  It computes
    every head's attention over its own slots, and the ranks' partials
    combine by their log-sum-exp: the maxima in one all-reduce, the outputs
    and sums rescaled to the overall max in another.  A rank with no
    visible key (an empty or windowed-out share) adds zero.  q: ``(B, T, H,
    hd)``; k, v: ``(B, S_loc, Hkv, hd)``; mask: ``(B, T, S_loc)`` or ``(T,
    S_loc)``.  Returns every head, ``(B, T, H hd)``."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, t, kv, h // kv, hd)
    s = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                     k.float()) * (cfg.hd ** -0.5)
    if cfg.attn_softcap is not None:
        s = torch.tanh(s / cfg.attn_softcap) * cfg.attn_softcap
    m = (mask if mask.dim() == 3 else mask[None])[:, None, None]
    s = torch.where(m, s, -1e30)
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.where(m, torch.exp(s - mx), 0.0)
    o = torch.einsum("bkgts,bskd->bkgtd", e, v.float())
    w = torch.exp(mx - tensor_parallel.all_reduce(mx, dist.ReduceOp.MAX))
    acc = tensor_parallel.all_reduce(
        torch.cat([o * w, e.sum(dim=-1, keepdim=True) * w], dim=-1))
    o, den = acc[..., :hd], acc[..., hd:]
    out = (o / torch.where(den > 0, den, 1.0)).permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, h * hd).to(v.dtype)


def _every_q_head(q: torch.Tensor, heads: Heads) -> torch.Tensor:
    """q ``(B, T, nq, hd)`` with every q head: gathered over ``model``
    where this rank holds its own (case C's decode gathers q whole)."""
    if heads.split and not isinstance(heads, Columns):
        return tensor_parallel.all_gather(q, 2)
    return q


def _kv_norm_rope(k: torch.Tensor, p: dict, pos: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Self-attention's keys as the ring holds them: qk-norm where
    configured, then RoPE at ``pos``."""
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return rope(k, pos, cfg.rope_theta)


def _fill_by_columns(cache: dict, own: tuple, p: dict, cfg: ModelConfig,
                     slots: torch.Tensor, L: int, lo: Optional[int],
                     pos: torch.Tensor, cpos: torch.Tensor) -> tuple:
    """Case C's prefill write of the ring's k and v, from this rank's
    columns of the written positions (``own``: k and v ``(B, tw, nkc)``
    before qk-norm and RoPE, which need whole heads).  Where the ring is
    split by length, the columns are scattered to their slots in a ring of
    the rank's columns and moved to its own slots with every column (one
    all-to-all, ``tensor_parallel.to_row_split``); qk-norm and RoPE then
    apply at the slots' positions (``cpos``, the rank's share of the
    written ``pos`` leaf), and the slots written take the new values.
    Where the ring is whole, the columns are gathered first."""
    b, tw = slots.shape
    hd = cfg.hd
    if lo is None:
        k, v = (tensor_parallel.all_gather(y, 2).reshape(b, tw, -1, hd)
                for y in own)
        k = _kv_norm_rope(k, p, pos, cfg)
        return (_ring_write(cache["k"], k, slots),
                _ring_write(cache["v"], v, slots))
    bi = torch.arange(b, device=slots.device)[:, None]
    n = cache["k"].shape[1]
    written = torch.zeros((b, L), dtype=torch.bool, device=slots.device)
    written[bi, slots] = True
    mine = written[:, lo:lo + n, None, None]
    out = []
    for name, y in zip(("k", "v"), own):
        ring = y.new_zeros((b, L, y.shape[-1]))
        ring[bi, slots] = y
        z = tensor_parallel.to_row_split(ring).reshape(b, n, -1, hd)
        if name == "k":
            z = _kv_norm_rope(z, p, cpos, cfg)
        out.append(torch.where(mine, z.to(cache[name].dtype), cache[name]))
    return tuple(out)


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx, *,
                    causal: bool = True, window: Optional[int] = None,
                    cross: bool = False):
    """Self- or cross-attention with ring caches for prefill/decode.

    ``p`` and ``ctx.cache``: the block's parameters and caches as the model
    holds them (DTensors under a mesh).  The parameters are gathered here
    for this rank's heads (:func:`attention_heads`); of the caches the rank
    computes on its shard (:func:`_local_cache`): k and v by heads in case
    A, else by length where the ring divides (a rank writes only the slots
    it holds, and decode combines the ranks' partial attention,
    :func:`_attend_split_ring`), and ``pos`` by length where it divides.
    In case C the rank projects its own columns, computes the heads they
    touch after a halo exchange (:func:`_halo`) at prefill and in train
    mode, and at decode gathers the one new token's q, k and v whole."""
    heads = attention_heads(p, cfg)
    p = _attention_params(p, heads, cfg)
    if heads.split:
        x = tensor_parallel.copy(x)
    b, t, _ = x.shape
    hd = cfg.hd
    cols = isinstance(heads, Columns)
    q = mm(x, p["wq"])
    if cross:
        return _apply_cross(p, q, cfg, ctx, heads)
    k, v = mm(x, p["wk"]), mm(x, p["wv"])
    decode = not (ctx.mode == "train" or ctx.cache is None
                  or ctx.mode == "prefill")
    own = (k, v)            # case C: the rank's columns, for the ring
    if cols and decode:
        q, k, v = (tensor_parallel.all_gather(y, 2) for y in (q, k, v))
    elif cols:
        q, k, v = _halo(q, cfg), _halo(k, cfg, True), _halo(v, cfg, True)
    q, k, v = (y.reshape(b, t, -1, hd) for y in (q, k, v))
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    pos = ctx.pos if ctx.pos is not None else \
        torch.arange(t, device=x.device)[None].expand(b, t)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)

    if not decode:
        # batch-uniform positions 0..T-1: the kernel's end-aligned mask, or
        # under autograd the reference's chunked attention on that mask
        kq, vq = _kv_for(k, v, heads, cfg)
        if _needs_grad(q, kq, vq):
            att = _attend(q, kq, vq,
                          _train_mask(t, causal, window, x.device), cfg)
        else:
            att = _attend_prefill(q, kq, vq, cfg, causal, window)
        out = _project_out(_own_columns(att, heads, hd, heads.q0), p["wo"],
                           heads)
        if ctx.mode != "prefill" or ctx.cache is None:
            return out, None
        # fill the ring with the last min(T, L) tokens for subsequent decode
        # (a ring cannot hold the full prefill when T > L; queries above
        #  already attended the exact windowed mask)
        cache, L, lo_k, lo_pos = _local_cache(ctx.cache, heads, cfg)
        tw = min(t, L)
        slots = pos[:, t - tw:] % L
        cpos = _ring_write(cache["pos"], pos[:, t - tw:], slots, lo_pos)
        if cols:
            ck, cv = _fill_by_columns(cache, tuple(y[:, t - tw:] for y in own),
                                      p, cfg, slots, L, lo_k, pos[:, t - tw:],
                                      cpos)
        else:
            ck = _ring_write(cache["k"], k[:, t - tw:], slots, lo_k)
            cv = _ring_write(cache["v"], v[:, t - tw:], slots, lo_k)
        return out, {"k": ck, "v": cv, "pos": cpos}

    # decode: ring cache (B, L, Kv, hd) + cache positions (B, L)
    cache, L, lo_k, lo_pos = _local_cache(ctx.cache, heads, cfg)
    slots = pos % L                                          # (B, T)
    ck = _ring_write(cache["k"], k, slots, lo_k)
    cv = _ring_write(cache["v"], v, slots, lo_k)
    cpos = _ring_write(cache["pos"], pos, slots, lo_pos)
    new_cache = {"k": ck, "v": cv, "pos": cpos}
    qp = pos[:, :, None]
    kp = (_whole_positions(cpos) if lo_pos is not None and lo_k is None
          else cpos)[:, None, :]                             # (B,1,L)
    mask = kp >= 0
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    if lo_k is not None:
        att = _own_columns(_attend_split_ring(_every_q_head(q, heads), ck,
                                              cv, mask, cfg), heads, hd)
    elif cols:
        qh = q[:, :, heads.q0: heads.q0 + heads.nq]
        kq, vq = _kv_for(ck, cv, _whole_kv(heads, cfg), cfg)
        att = _own_columns(_attend_dense(qh, kq, vq, mask, cfg), heads, hd,
                           heads.q0)
    else:
        kq, vq = _kv_for(ck, cv, heads, cfg)
        att = _attend_dense(q, kq, vq, mask, cfg)
    return _project_out(att, p["wo"], heads), new_cache


def _apply_cross(p: dict, q: torch.Tensor, cfg: ModelConfig, ctx: Ctx,
                 heads: Heads):
    """Cross-attention of q (B, T, nq hd, this rank's columns) over the
    memory: no RoPE, every key visible.  Keys and values are projected from
    ``ctx.memory`` at prefill and in train mode (and become the cache: this
    rank's share of the memory's positions where the cache is split by
    length), and read from the cache at decode; qk-norm, where configured,
    applies on every read, as the reference applies it.  In case C, q's
    columns and the memory's k and v columns take the halo exchange at
    prefill and in train mode (the cache then takes every column of the
    rank's positions, one all-to-all, or every column where it is whole),
    and q is gathered whole at decode."""
    b, t = q.shape[:2]
    hd = cfg.hd
    cols = isinstance(heads, Columns)
    cache, lo = ctx.cache, None
    if cache is not None:
        cache, _, lo, _ = _local_cache(cache, heads, cfg)
    decode = cache is not None and "k" in cache and ctx.mode == "decode"
    if cols:
        q = tensor_parallel.all_gather(q, 2) if decode else _halo(q, cfg)
    q = q.reshape(b, t, -1, hd)
    if decode:
        k, v = cache["k"], cache["v"]
        new_cache = cache
    else:
        mem = ctx.memory
        if heads.split:
            mem = tensor_parallel.copy(mem)
        k, v = mm(mem, p["wk"]), mm(mem, p["wv"])
        if cols:
            new_cache = None if cache is None else {
                name: (tensor_parallel.all_gather(y, 2) if lo is None
                       else tensor_parallel.to_row_split(y)
                       ).reshape(b, -1, cfg.n_kv_heads, hd)
                for name, y in (("k", k), ("v", v))}
            k, v = _halo(k, cfg, True), _halo(v, cfg, True)
        k, v = k.reshape(b, -1, heads.nk, hd), v.reshape(b, -1, heads.nk, hd)
        if not cols:
            new_cache = {"k": k, "v": v}
            if lo is not None:
                own = slice(lo, lo + cache["k"].shape[1])
                new_cache = {"k": k[:, own].contiguous(),
                             "v": v[:, own].contiguous()}
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    mask = torch.ones((t, k.shape[1]), dtype=torch.bool, device=q.device)
    if decode and lo is not None:
        out = _own_columns(_attend_split_ring(_every_q_head(q, heads), k, v,
                                              mask, cfg), heads, hd)
    else:
        kv_heads = heads
        if cols and decode:        # q whole, the cache every kv head
            q, kv_heads = q[:, :, heads.q0: heads.q0 + heads.nq], \
                _whole_kv(heads, cfg)
        kq, vq = _kv_for(k, v, kv_heads, cfg)
        if decode or _needs_grad(q, kq, vq):
            out = _attend(q, kq, vq, mask, cfg)  # one query at decode: dense
        else:
            out = _attend_prefill(q, kq, vq, cfg, causal=False, window=None)
        out = _own_columns(out, heads, hd, heads.q0)
    return _project_out(out, p["wo"], heads), new_cache


def _ring_write(buf: torch.Tensor, vals: torch.Tensor, slots: torch.Tensor,
                lo: Optional[int] = None) -> torch.Tensor:
    """buf: (B, L, ...), vals: (B, T, ...), slots: (B, T) -> a new buffer
    with ``vals`` scattered to ``slots`` (cast to buf's type); ``buf`` is
    left as it was, as the reference's functional update leaves it.
    ``lo``: ``buf`` holds only the ring's slots ``[lo, lo + L)`` (a rank's
    share of a ring split by length), and writes to others are dropped."""
    bi = torch.arange(buf.shape[0], device=buf.device)[:, None]
    if lo is None:
        out = buf.clone()
        out[bi, slots] = vals.to(buf.dtype)
        return out
    n = buf.shape[1]
    local = slots - lo
    out = torch.cat([buf, buf[:, :1]], dim=1)     # slot n takes the drops
    out[bi, torch.where((local >= 0) & (local < n), local, n)] = \
        vals.to(buf.dtype)
    return out[:, :n].contiguous()


def init_attention_cache(cfg: ModelConfig, batch: int, length: int,
                         dtype: torch.dtype, device) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.hd
    return {"k": torch.zeros((batch, length, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, length, kv, hd), dtype=dtype,
                             device=device),
            "pos": torch.full((batch, length), -1, dtype=torch.int32,
                              device=device)}


# ---------------------------------------------------------------------- ffn
def init_mlp(cfg: ModelConfig, dense: Dense, dtype: torch.dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"wi": dense((d, f), dtype), "wg": dense((d, f), dtype),
            "wo": dense((f, d), dtype)}


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The gated MLP.  ``p``: as the model holds it (DTensors under a
    mesh).  Where the rule splits ``wi`` / ``wg`` by columns and ``wo`` by
    rows over ``model`` (``tensor_parallel``), each model rank computes its
    ``d_ff / tp`` hidden units and the partial outputs are summed over
    ``model``; else the weights are gathered whole."""
    dim = act_ctx.model_split_dim
    if (tensor_parallel.size() > 1 and dim(p["wi"]) == 1
            and dim(p["wg"]) == 1 and dim(p["wo"]) == 0):
        w = tensor_parallel.shards(p, keep=("wi", "wg", "wo"))
        x = tensor_parallel.copy(x)
        return tensor_parallel.reduce(
            mm(F.silu(mm(x, w["wg"])) * mm(x, w["wi"]), w["wo"]))
    p = act_ctx.materialize(p)
    return mm(F.silu(mm(x, p["wg"])) * mm(x, p["wi"]), p["wo"])


# ---------------------------------------------------------------------- moe
def init_moe(cfg: ModelConfig, dense: Dense, dtype: torch.dtype) -> dict:
    """Router (kept f32 under bf16 weights, as the reference keeps it), the
    experts' stacked ``(E, D, F)`` / ``(E, F, D)`` weights, and arctic's
    dense residual MLP."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.n_experts
    p = {"router": dense((d, e), torch.float32),
         "wi": dense((e, d, f), dtype), "wg": dense((e, d, f), dtype),
         "wo": dense((e, f, d), dtype)}
    if m.dense_residual:
        p["dense"] = init_mlp(cfg, dense, dtype)
    return p


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE FFN, on the reference's two paths:

    * expert parallel (a mesh installed whose ``model`` axis is larger than
      1 and divides the experts, a global batch the data-parallel ranks
      divide, more than one position, the experts' placements split over
      ``model``): every model rank owns ``E / tp``
      experts, gathers only their weights over ``data``, buckets its local
      tokens for them (every model rank's, where ``model`` carries batch
      rows), and one sum over ``model`` combines
      (:func:`_apply_moe_shardmap`);
    * the single-device dispatch otherwise (:func:`_apply_moe_xla`; under a
      mesh every rank computes it with its parameters gathered).

    ``p`` is the layer's parameters as the model holds them (DTensors under
    a mesh): each path gathers what it needs (``act_ctx.materialize``)."""
    mesh = act_ctx.mesh()
    if (mesh is not None and "model" in mesh.mesh_dim_names
            and act_ctx.axis_size(mesh, "model") > 1
            and cfg.moe.n_experts % act_ctx.axis_size(mesh, "model") == 0
            and act_ctx.global_batch(x.shape[0]) % act_ctx.dp_size() == 0
            # decode (T == 1): the per-step gather of the experts' weights
            # would dwarf the few active tokens (the reference's reason)
            and x.shape[1] > 1
            # the experts split over ``model``: ``zero3`` places experts
            # that ``data`` x ``model`` does not divide over ``data`` alone,
            # and every rank gathers them whole whichever path it takes
            and act_ctx.model_split_dim(p["wi"]) == 0):
        return _apply_moe_shardmap(p, x, cfg, mesh)
    return _apply_moe_xla({k: v if k == "dense" else act_ctx.materialize(v)
                           for k, v in p.items()}, x, cfg)


def _bucket_and_run(xt, w, ids, wi, wg, wo, n_buckets: int, cap: int,
                    bucket_of, dtype) -> torch.Tensor:
    """Slot assignments into (n_buckets, cap), run experts, combine back.
    ``bucket_of >= n_buckets`` marks an assignment as dropped.  The slot
    arithmetic is the reference's: assignments sorted stably by bucket,
    each one's place in its bucket its index minus the bucket's first, the
    ones past ``cap`` dropped (written to a discard row)."""
    tk = ids.numel()
    k = ids.shape[-1]
    d = xt.shape[-1]
    dev = xt.device
    flat_b = bucket_of.reshape(-1)
    order = torch.argsort(flat_b, stable=True)
    sorted_b = flat_b[order]
    grp = (torch.arange(tk, device=dev)
           - torch.searchsorted(sorted_b, sorted_b, side="left"))
    keep = (sorted_b < n_buckets) & (grp < cap)
    slot = torch.where(keep, sorted_b * cap + grp, n_buckets * cap)
    tok = order // k
    buf = torch.zeros((n_buckets * cap + 1, d), dtype=dtype, device=dev)
    buf[slot] = torch.where(keep[:, None], xt[tok], 0).to(dtype)
    xe = buf[: n_buckets * cap].reshape(n_buckets, cap, d)
    h = F.silu(mm(xe, wg)) * mm(xe, wi)
    ye = mm(h, wo).reshape(n_buckets * cap, d)
    back = torch.where(keep[:, None],
                       ye[torch.clamp(slot, max=n_buckets * cap - 1)], 0)
    w_sorted = w.reshape(-1)[order].to(dtype)
    out = torch.zeros((xt.shape[0], d), dtype=dtype, device=dev)
    return out.index_add_(0, tok, (back * w_sorted[:, None]).to(dtype))


def _apply_moe_shardmap(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh
                        ) -> torch.Tensor:
    """Expert parallelism in explicit collectives (the reference's
    ``shard_map`` body): this model rank's experts gathered over ``data``
    (their gradients reduce-scattered back), the router gathered (its
    gradient summed over ``model`` too: each rank routes the same tokens
    but back-propagates through its own experts' weights only), the local
    tokens routed and bucketed for the rank's experts alone, their outputs
    summed over ``model``.  Capacity is per rank, from the tokens it
    buckets, as in the reference.  The dense residual runs outside,
    tensor-parallel as every MLP (:func:`apply_mlp`).

    Where ``model`` carries batch rows (``zero3`` with a batch that every
    axis divides) the model ranks hold different tokens, and the
    reference's sum over ``model`` would add different rows together.
    There the tokens of every model rank are gathered
    (``tensor_parallel.all_gather``), routed and bucketed by each rank for
    its experts, and the outputs summed back into each rank's own rows
    (``tensor_parallel.reduce_scatter``); the experts stay split."""
    m = cfg.moe
    d = x.shape[-1]
    tp = act_ctx.axis_size(mesh, "model")
    group = mesh.get_group("model")
    e, k = m.n_experts, m.top_k
    e_loc = e // tp
    experts = act_ctx.materialize({n: p[n] for n in ("wi", "wg", "wo")},
                                  keep=("model",))
    router = act_ctx.materialize(p["router"], partial=("model",))
    mi = mesh.get_local_rank("model")
    rows = "model" in act_ctx.dp_axes()
    xt = x.reshape(-1, d)
    xt = tensor_parallel.all_gather(xt, 0) if rows else \
        tensor_parallel.copy(xt, group)
    t_loc = xt.shape[0]
    cap = max(1, int(math.ceil(t_loc * k / e * m.capacity_factor)))
    probs = torch.softmax(mm(xt.float(), router.to(x.dtype)), dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)                    # (t_loc, k)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    # assignments owned by this model rank; others -> bucket e_loc (drop)
    local_e = ids - mi * e_loc
    bucket_of = torch.where((local_e >= 0) & (local_e < e_loc), local_e,
                            e_loc)
    out = _bucket_and_run(xt, w, ids, experts["wi"], experts["wg"],
                          experts["wo"], e_loc, cap, bucket_of, x.dtype)
    out = (tensor_parallel.reduce_scatter(out, 0) if rows else
           tensor_parallel.reduce(out, group)).reshape(x.shape)
    if m.dense_residual:
        out = out + apply_mlp(p["dense"], x)
    return out


def _apply_moe_xla(p: dict, x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    """Sort-based top-k dispatch with static per-expert capacity (tokens
    past an expert's capacity are dropped), in plain torch ops."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    probs = torch.softmax(mm(xt.float(), p["router"]), dim=-1)
    w, ids = torch.topk(probs, m.top_k, dim=-1)              # (T, k)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    e, k = m.n_experts, m.top_k
    cap = max(1, int(math.ceil(t * k / e * m.capacity_factor)))
    out = _bucket_and_run(xt, w, ids, p["wi"], p["wg"], p["wo"], e, cap,
                          ids, x.dtype)
    if m.dense_residual:
        out = out + apply_mlp(p["dense"], xt)
    return out.reshape(b, s, d)


# -------------------------------------------------------------------- rglru
def init_rglru(cfg: ModelConfig, dense: Dense, dtype: torch.dtype,
               device) -> dict:
    d = cfg.d_model
    w = int(cfg.rglru_expand * d)
    return {"wx": dense((d, w), dtype),
            "wy": dense((d, w), dtype),      # gate branch
            "conv": dense((cfg.conv_width, w), dtype),
            "a_log": torch.full((w,), 0.5, dtype=torch.float32,
                                device=device),
            "wgx": dense((w, w), dtype),     # input gate
            "wga": dense((w, w), dtype),     # recurrence gate
            "wo": dense((w, d), dtype)}


def _rglru_split(p: dict) -> bool:
    """Whether the RG-LRU block with parameters ``p`` (as the model holds
    them) splits its channels over ``model``: its placements split ``wx`` /
    ``wy`` by columns and ``wo`` by rows (``param_spec``'s rule, where the
    width divides)."""
    dim = act_ctx.model_split_dim
    return (tensor_parallel.size() > 1 and dim(p["wx"]) == 1
            and dim(p["wy"]) == 1 and dim(p["wo"]) == 0)


def _channel_states(cache: dict, split: bool, block: str) -> dict:
    """A block's states whose last dim is its channels (the RG-LRU's, the
    sLSTM's), as this rank's local tensors.  Split over ``model``, the
    states come placed (``cache_spec``: their channels over ``model``), and
    a rank's are its channels; plain tensors raise there, since their
    shape cannot say whether they are a shard."""
    if not split:
        return {k: act_ctx.local(v) for k, v in cache.items()}
    if not all(isinstance(v, DTensor) for v in cache.values()):
        raise ValueError(f"under tensor parallelism the {block} takes its "
                         f"caches placed (DTensors), not their local shards")
    dims = {k: act_ctx.model_split_dim(v) for k, v in cache.items()}
    if dims != {k: v.dim() - 1 for k, v in cache.items()}:
        raise ValueError(f"{block} states split over 'model' on {dims}, "
                         f"not on their channels")
    return {k: act_ctx.local(v) for k, v in cache.items()}


def apply_rglru(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    """RecurrentGemma recurrent block: proj -> causal conv -> RG-LRU -> gate.

    ``p`` and ``ctx.cache``: as the model holds them (DTensors under a
    mesh).  Where :func:`_rglru_split`, rank ``r`` of ``tp`` computes
    channels ``[r Wl, (r + 1) Wl)``, ``Wl = W / tp``: ``wx`` / ``wy`` keep
    their column shard and ``wo`` its row shard, the conv's taps and
    ``a_log`` are sliced, and the scan runs on ``(B, T, Wl)``; the states
    are the rank's channels.  The gates ``wga`` / ``wgx`` are dense ``W x W``
    and not split by their placements, so each channel's gate reads the
    whole conv output: the ranks' conv outputs are all-gathered
    (``tensor_parallel.all_gather``) and multiplied by the gates' ``Wl``
    columns, gathered whole with their gradient summed over ``model``.  The
    other way, a partial product ``conv_r @ wg[rows]`` reduce-scattered to
    the rank's columns, moves the two gates' ``2 W`` columns where the
    gather moves ``W``, and would sum each gate's dot product over ranks.
    The output's partial sums over ``wo``'s rows meet over ``model``."""
    split = _rglru_split(p)
    w = tensor_parallel.shards(p, keep=("wx", "wy", "wo"),
                               partial=("conv", "a_log", "wga", "wgx")) \
        if split else act_ctx.materialize(p)
    conv_w, a_log, wga, wgx = w["conv"], w["a_log"], w["wga"], w["wgx"]
    if split:
        x = tensor_parallel.copy(x)
        n = w["wx"].shape[1]
        cols = slice(tensor_parallel.rank() * n,
                     (tensor_parallel.rank() + 1) * n)
        conv_w, a_log, wga, wgx = (conv_w[:, cols], a_log[cols],
                                   wga[:, cols], wgx[:, cols])
    t = x.shape[1]
    u = mm(x, w["wx"])                                       # (B,T,W)
    gate = F.gelu(mm(x, w["wy"]), approximate="tanh")        # jax.nn.gelu
    cache = _channel_states(ctx.cache, split, "RG-LRU") if ctx.cache \
        else {}
    cw = cfg.conv_width
    if ctx.mode == "decode" and "conv" in cache:
        hist = torch.cat([cache["conv"], u], dim=1)          # (B, cw-1+T, W)
    else:
        hist = F.pad(u, (0, 0, cw - 1, 0))
    conv = sum(hist[:, i: i + t] * conv_w[i][None, None]
               for i in range(cw))
    whole = tensor_parallel.all_gather(conv, -1) if split else conv
    ga = torch.sigmoid(mm(whole, wga))
    gx = torch.sigmoid(mm(whole, wgx))
    c = 8.0
    log_a = -c * F.softplus(a_log)[None, None] * ga.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - a ** 2, min=1e-12))
    un = (gx * conv).float() * mult
    if ctx.mode == "decode" and "h" in cache:
        h = a[:, 0] * cache["h"] + un[:, 0]
        hs = h[:, None]
    else:
        hs = RGLRUScan.apply(un, a)
        h = hs[:, -1].clone()          # the cache keeps (B, W), not hs
    new_cache = {"conv": hist[:, -(cw - 1):] if cw > 1 else hist[:, :0],
                 "h": h} if ctx.mode != "train" else None
    y = mm(hs.to(x.dtype) * gate, w["wo"])
    return (tensor_parallel.reduce(y) if split else y), new_cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> dict:
    w = int(cfg.rglru_expand * cfg.d_model)
    return {"conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}


# -------------------------------------------------------------------- xlstm
def init_mlstm(cfg: ModelConfig, dense: Dense, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    w = int(cfg.mlstm_expand * d)
    return {"wu": dense((d, w), dtype), "wg": dense((d, w), dtype),
            "wq": dense((w, w), dtype), "wk": dense((w, w), dtype),
            "wv": dense((w, w), dtype), "wi": dense((w, cfg.n_heads), dtype),
            "wf": dense((w, cfg.n_heads), dtype), "wo": dense((w, d), dtype)}


def _mlstm_sequential(q, k, v, log_i, log_f, c0, n0, m0):
    """Exact stabilized recurrence (decode path + chunkwise test oracle).
    q,k,v: (B,T,H,hd) f32; log_i/log_f: (B,T,H) f32; a loop over T."""
    c, n, m = c0, n0, m0
    hs = []
    for i in range(q.shape[1]):
        qt, kt, vt, li, lf = q[:, i], k[:, i], v[:, i], log_i[:, i], \
            log_f[:, i]
        m_new = torch.maximum(lf + m, li)
        f_ = torch.exp(lf + m - m_new)[..., None]            # (B,H,1)
        i_ = torch.exp(li - m_new)[..., None]
        n = f_ * n + i_ * kt
        c = f_[..., None] * c + i_[..., None] * (vt[..., :, None]
                                                 * kt[..., None, :])
        num = torch.einsum("bhij,bhj->bhi", c, qt)
        den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", n, qt)),
                          min=1.0)
        m = m_new
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=1), (c, n, m)


def _mlstm_chunk(c_in, n_in, m_in, q, k, v, log_i, log_f):
    """One chunk of the stabilized chunkwise-parallel mLSTM (the form real
    kernels use: BPTT stores O(T/L) inter-chunk states, not O(T) matrices).

    q,k,v: (B,H,L,hd) f32; log_i/log_f: (B,H,L) f32; carry (C, n, m).
    Returns (C, n, m) at the chunk's exit and h (B,H,L,hd)."""
    L = q.shape[2]
    b_cum = torch.cumsum(log_f, dim=-1)                      # inclusive decay
    # intra-chunk pairwise log-weights: b_t - b_j + log_i_j for j <= t
    dmat = b_cum[..., :, None] - b_cum[..., None, :] + log_i[..., None, :]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))
    dmat = torch.where(causal, dmat, -torch.inf)
    m_intra = torch.amax(dmat, dim=-1)                       # (B,H,L)
    m_inter = m_in[..., None] + b_cum                        # (B,H,L)
    m_t = torch.maximum(m_inter, m_intra)
    d = torch.exp(dmat - m_t[..., None])                     # (B,H,L,L)
    r = torch.exp(m_inter - m_t)                             # (B,H,L)
    scores = torch.einsum("bhtd,bhjd->bhtj", q, k) * d
    num = (torch.einsum("bhtj,bhjd->bhtd", scores, v)
           + r[..., None] * torch.einsum("bhij,bhtj->bhti", c_in, q))
    den = (torch.sum(scores, dim=-1)
           + r * torch.einsum("bhj,bhtj->bht", n_in, q))
    h = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
    # chunk-exit state
    b_last = b_cum[..., -1]
    m_out = torch.maximum(m_in + b_last, torch.amax(
        b_last[..., None] - b_cum + log_i, dim=-1))
    w = torch.exp(b_last[..., None] - b_cum + log_i - m_out[..., None])
    decay = torch.exp(m_in + b_last - m_out)
    c_out = (decay[..., None, None] * c_in
             + torch.einsum("bhj,bhjv,bhjk->bhvk", w, v, k))
    n_out = decay[..., None] * n_in + torch.einsum("bhj,bhjk->bhk", w, k)
    return c_out, n_out, m_out, h


def _mlstm_split(p: dict, cfg: ModelConfig) -> bool:
    """Whether the mLSTM block with parameters ``p`` (as the model holds
    them) splits over ``model``: its placements split ``wu``, ``wg``,
    ``wq``, ``wk``, ``wv`` by columns and ``wo`` by rows (``param_spec``'s
    rule, where the width divides), and a rank's block of columns is whole
    heads or lies inside one head (``model`` divides the heads, or they
    divide it)."""
    tp = tensor_parallel.size()
    dim = act_ctx.model_split_dim
    return (tp > 1 and dim(p["wo"]) == 0
            and all(dim(p[k]) == 1 for k in ("wu", "wg", "wq", "wk", "wv"))
            and (cfg.n_heads % tp == 0 or tp % cfg.n_heads == 0))


@functools.lru_cache(maxsize=None)
def _mlstm_parts(h: int, hd: int, tp: int, split: bool) -> tuple:
    """For each model rank, in rank order, the part of the mLSTM it
    computes, ``(h0, nh, v0, nv)``: value rows ``[v0, v0 + nv)`` of heads
    ``[h0, h0 + nh)``, which is its block of the ``h hd`` columns: whole
    heads where ``model`` divides them, else ``hd / (tp / h)`` rows of one
    head.  Unsplit, every rank computes everything."""
    if not split:
        return ((0, h, 0, hd),) * tp
    if h % tp == 0:
        n = h // tp
        return tuple((r * n, n, 0, hd) for r in range(tp))
    s = tp // h
    return tuple((r // s, 1, r % s * (hd // s), hd // s) for r in range(tp))


def _placed_parts(t: DTensor, tp: int) -> tuple:
    """The layout (``tensor_parallel.relayout``) of an mLSTM state placed
    as ``t``, ``(B, H, X, ...)`` or ``(B, H)`` (X = 1): its rows ``(H, X)``
    split over ``model`` by heads (dim 1) or by X (dim 2), or whole."""
    h, x = t.shape[1], t.shape[2] if t.dim() > 2 else 1
    d = act_ctx.model_split_dim(t)
    if d == 1:
        return tuple((r * (h // tp), h // tp, 0, x) for r in range(tp))
    if d == 2:
        return tuple((0, h, r * (x // tp), x // tp) for r in range(tp))
    if d is None:
        return ((0, h, 0, x),) * tp
    raise ValueError(f"an mLSTM state split over 'model' on dim {d}")


def _mlstm_layouts(cache: dict, parts: tuple) -> dict:
    """Each state's (layout as placed, layout as computed, width): ``C``
    ``(B, H, hd_v, hd_k)`` is computed on the rank's value rows, ``n`` ``(B,
    H, hd_k)`` and ``m`` ``(B, H)`` on its heads, whole."""
    hd = cache["C"].shape[-1]
    tp = len(parts)
    comp = {"C": (parts, hd),
            "n": (tuple((h0, nh, 0, hd) for h0, nh, _, _ in parts), hd),
            "m": (tuple((h0, nh, 0, 1) for h0, nh, _, _ in parts), 1)}
    return {k: (_placed_parts(cache[k], tp), *comp[k]) for k in comp}


def _mlstm_states_in(cache: dict, parts: tuple) -> tuple:
    """The states ``(C, n, m)`` as this rank computes with them: under
    tensor parallelism they come placed (DTensors, by ``cache_spec``) and
    move into the rank's part (:func:`_mlstm_parts`); plain tensors raise
    there, since their shape cannot say whether they are a shard."""
    if tensor_parallel.size() == 1:
        return tuple(act_ctx.local(cache[k]) for k in ("C", "n", "m"))
    if not all(isinstance(cache[k], DTensor) for k in ("C", "n", "m")):
        raise ValueError("under tensor parallelism the mLSTM takes its "
                         "caches placed (DTensors), not their local shards")
    out = []
    for k, (placed, comp, width) in _mlstm_layouts(cache, parts).items():
        t = act_ctx.local(cache[k])
        b, rest = t.shape[0], t.shape[3:]
        _, nh, _, nx = comp[tensor_parallel.rank()]
        moved = tensor_parallel.relayout(t.reshape(b, -1, *rest), placed,
                                         comp, width)
        out.append(moved.reshape((b, nh, nx, *rest) if t.dim() > 2
                                 else (b, nh)))
    return tuple(out)


def _mlstm_states_out(cache: dict, parts: tuple, states: tuple) -> dict:
    """The new states back in the placement of the old (``cache``): this
    rank's shards, the inverse move of :func:`_mlstm_states_in`."""
    out = {}
    for (k, (placed, comp, width)), new in zip(
            _mlstm_layouts(cache, parts).items(), states):
        shape = act_ctx.local(cache[k]).shape
        out[k] = tensor_parallel.relayout(
            new.reshape(new.shape[0], -1, *new.shape[3:]), comp, placed,
            width).reshape(shape)
    return out


def apply_mlstm(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    """mLSTM (xLSTM Sec. 2.3): chunkwise-parallel stabilized form for
    train/prefill (chunk = cfg.mlstm_chunk), exact recurrence for decode.
    Each chunk runs under ``torch.utils.checkpoint`` where autograd is
    recording, as the reference's under ``jax.checkpoint``.

    State per head: C (hd,hd) matrix memory, n (hd,), m () stabilizer.

    ``p`` and ``ctx.cache``: as the model holds them (DTensors under a
    mesh).  Where :func:`_mlstm_split`, rank ``r`` computes its block of
    the ``w`` columns (:func:`_mlstm_parts`): ``wu``, ``wg``, ``wq``,
    ``wk``, ``wv`` keep their column shard and ``wo`` its row shard, and
    ``wi`` / ``wf`` theirs where ``model`` divides the heads (else they are
    gathered with their gradient summed over ``model`` and sliced to the
    rank's head).  ``wq`` / ``wk`` / ``wv`` read ``u`` whole, so the ranks'
    ``u`` is all-gathered; a rank that holds part of one head gathers q and
    k too (once, before the chunks), since its head's scores, ``C q`` and
    ``n q`` read them whole, and keeps its own value rows of ``v`` and
    ``C``.  The output's partial sums over ``wo``'s rows meet over
    ``model``.  The states come placed by ``cache_spec`` (``C`` split by
    every head's value rows, ``n`` by every head's k entries, ``m`` by
    heads where they divide), which is not the products' layout; they move
    into it at entry and back at exit (``tensor_parallel.relayout``, an
    all-to-all each where data moves): the states are smaller than a
    prompt's activations, and at decode both are small.  Without
    incoming states (train, or a prefill given none) there is no placement
    to return them in, and under tensor parallelism none are returned."""
    b, t, _ = x.shape
    h = cfg.n_heads
    tp = tensor_parallel.size()
    split = _mlstm_split(p, cfg)
    if split:
        gates = tuple(k for k in ("wi", "wf")
                      if act_ctx.model_split_dim(p[k]) == 1)
        p = tensor_parallel.shards(
            p, keep=("wu", "wg", "wq", "wk", "wv", "wo") + gates,
            partial=("wi", "wf"))
        x = tensor_parallel.copy(x)
    else:
        p = act_ctx.materialize(p)
    u = mm(x, p["wu"])
    gate = F.silu(mm(x, p["wg"]))
    if split:
        u = tensor_parallel.all_gather(u, -1)
    w = u.shape[-1]
    hd = w // h
    parts = _mlstm_parts(h, hd, tp, split)
    h0, nh, _, nv = parts[tensor_parallel.rank() if tp > 1 else 0]

    def own_head(a):                     # (B, T, w / tp) -> the head's hd
        return tensor_parallel.all_gather(a, -1)[..., h0 * hd:(h0 + 1) * hd] \
            if nv < hd else a

    def own_heads(wt):                   # (w, H) -> the rank's heads
        return wt if wt.shape[1] == nh else wt[:, h0:h0 + nh]

    q = own_head(mm(u, p["wq"])).reshape(b, t, nh, hd).float()
    k = own_head(mm(u, p["wk"]) / math.sqrt(hd)).reshape(b, t, nh,
                                                         hd).float()
    v = mm(u, p["wv"]).reshape(b, t, nh, nv).float()
    log_i = torch.clamp(mm(u, own_heads(p["wi"])), -10.0,
                        10.0).float()                           # (B,T,nh)
    log_f = F.logsigmoid(mm(u, own_heads(p["wf"])).float())

    cache = ctx.cache or {}
    if "C" in cache:
        c0, n0, m0 = _mlstm_states_in(cache, parts)
    else:
        dev = x.device
        c0 = torch.zeros((b, nh, nv, hd), dtype=torch.float32, device=dev)
        n0 = torch.zeros((b, nh, hd), dtype=torch.float32, device=dev)
        m0 = torch.full((b, nh), -torch.inf, dtype=torch.float32, device=dev)

    L = cfg.mlstm_chunk
    if t == 1 or ctx.mode == "decode":
        hs, (cT, nT, mT) = _mlstm_sequential(q, k, v, log_i, log_f, c0, n0,
                                             m0)
    else:
        # pad T to a chunk multiple; padded steps get log_i=-inf (no effect)
        tpad = (t + L - 1) // L * L

        def heads_first(a, fill=0.0):             # (B,T,H,...) -> (B,H,Tp,...)
            pad = [0, 0] * (a.dim() - 2) + [0, tpad - t]
            return F.pad(a, pad, value=fill).movedim(2, 1)

        qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
        lih, lfh = heads_first(log_i, -torch.inf), heads_first(log_f)
        carry, outs = (c0, n0, m0), []
        grad = torch.is_grad_enabled()
        for j in range(tpad // L):
            cols = slice(j * L, (j + 1) * L)
            args = (*carry, qh[:, :, cols], kh[:, :, cols], vh[:, :, cols],
                    lih[:, :, cols], lfh[:, :, cols])
            if grad:
                *carry, hj = checkpoint(_mlstm_chunk, *args,
                                        use_reentrant=False)
            else:
                *carry, hj = _mlstm_chunk(*args)
            outs.append(hj)
        cT, nT, mT = carry
        # (B,H,Tp,hd) -> (B,T,H,hd)
        hs = torch.cat(outs, dim=2).movedim(1, 2)[:, :t]
    out = hs.reshape(b, t, nh * nv).to(x.dtype)
    if ctx.mode == "train":
        new_cache = None
    elif tp == 1:
        new_cache = {"C": cT, "n": nT, "m": mT}
    else:
        new_cache = _mlstm_states_out(cache, parts, (cT, nT, mT)) \
            if "C" in cache else None
    y = mm(out * gate, p["wo"])
    return (tensor_parallel.reduce(y) if split else y), new_cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    w = int(cfg.mlstm_expand * cfg.d_model)
    hd = w // cfg.n_heads
    f32 = torch.float32
    return {"C": torch.zeros((batch, cfg.n_heads, hd, hd), dtype=f32,
                             device=device),
            "n": torch.zeros((batch, cfg.n_heads, hd), dtype=f32,
                             device=device),
            "m": torch.full((batch, cfg.n_heads), -torch.inf, dtype=f32,
                            device=device)}


def init_slstm(cfg: ModelConfig, dense: Dense, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    f = int(cfg.slstm_proj * d)
    return {"wz": dense((d, d), dtype), "wi": dense((d, d), dtype),
            "wf": dense((d, d), dtype), "wo": dense((d, d), dtype),
            "up": dense((d, f), dtype), "down": dense((f, d), dtype)}


def _slstm_split(p: dict) -> bool:
    """Whether the sLSTM block with parameters ``p`` (as the model holds
    them) splits its channels over ``model``: its placements split ``wi``
    by columns and ``wo`` (the output gate's) by rows."""
    dim = act_ctx.model_split_dim
    return tensor_parallel.size() > 1 and dim(p["wi"]) == 1 and \
        dim(p["wo"]) == 0


def apply_slstm(p: dict, x: torch.Tensor, cfg: ModelConfig, ctx: Ctx):
    """sLSTM (xLSTM Sec. 2.2): scalar memory, exp input gating, stabilized;
    the reference's sequential step in a loop over T.

    ``p`` and ``ctx.cache``: as the model holds them (DTensors under a
    mesh).  The recurrence is per channel, so where :func:`_slstm_split`
    rank ``r`` runs it on its ``d / tp`` channels, the states' placement
    (``cache_spec``): ``log_i`` from ``wi``'s column shard, ``z`` and
    ``log_f`` from ``wz`` / ``wf`` gathered (with their gradient summed
    over ``model``) and sliced to the rank's columns, and the output gate
    from ``wo``'s row shard, the rank's channels of ``x`` times its rows,
    reduce-scattered to its channels.  ``up`` contracts over every
    channel: the ranks' outputs are gathered and ``up`` / ``down``, which
    ``param_spec`` leaves whole where ``model`` does not divide their
    width (xlstm-350m's 1,365), run whole on every rank, which moves ``d``
    values a position where a sum of partial products would move ``2 f``.
    Where their placements split them, ``up``'s columns and ``down``'s rows
    stay split and their partial outputs meet over ``model``."""
    b, t, d = x.shape
    dim = act_ctx.model_split_dim
    split = _slstm_split(p)
    ffn = split and dim(p["up"]) == 1 and dim(p["down"]) == 0
    if split:
        w = tensor_parallel.shards(
            p, keep=("wi", "wo") + (("up", "down") if ffn else ()),
            partial=("wz", "wf"))
        x = tensor_parallel.copy(x)
        nc = w["wi"].shape[1]
        cols = slice(tensor_parallel.rank() * nc,
                     (tensor_parallel.rank() + 1) * nc)
        wz, wi, wf = w["wz"][:, cols], w["wi"], w["wf"][:, cols]
        o_in = tensor_parallel.reduce_scatter(mm(x[..., cols], w["wo"]), -1)
    else:
        w = act_ctx.materialize(p)
        wz, wi, wf = w["wz"], w["wi"], w["wf"]
        o_in = mm(x, w["wo"])
    z = torch.tanh(mm(x, wz)).float()
    log_i = torch.clamp(mm(x, wi), -10, 10).float()
    log_f = F.logsigmoid(mm(x, wf).float())
    o = torch.sigmoid(o_in).float()

    cache = _channel_states(ctx.cache, split, "sLSTM") if ctx.cache else {}
    if "c" in cache:
        c, n, m = cache["c"], cache["n"], cache["m"]
    else:
        shape = (b, z.shape[-1])                  # the rank's channels
        c = torch.zeros(shape, dtype=torch.float32, device=x.device)
        n = torch.zeros(shape, dtype=torch.float32, device=x.device)
        m = torch.full(shape, -torch.inf, dtype=torch.float32,
                       device=x.device)
    hs = []
    for i in range(t):
        li, lf = log_i[:, i], log_f[:, i]
        m_new = torch.maximum(lf + m, li)
        f_ = torch.exp(lf + m - m_new)
        i_ = torch.exp(li - m_new)
        c = f_ * c + i_ * z[:, i]
        n = f_ * n + i_
        m = m_new
        hs.append(o[:, i] * c / torch.clamp(n, min=1.0))
    out = torch.stack(hs, dim=1).to(x.dtype)
    new_cache = {"c": c, "n": n, "m": m} if ctx.mode != "train" else None
    if split:
        out = (tensor_parallel.all_gather if ffn
               else tensor_parallel.gather)(out, -1)
    y = mm(out, w["up"])
    y = mm(F.gelu(y, approximate="tanh"), w["down"])
    return (tensor_parallel.reduce(y) if ffn else y), new_cache


def init_slstm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    d = cfg.d_model
    f32 = torch.float32
    return {"c": torch.zeros((batch, d), dtype=f32, device=device),
            "n": torch.zeros((batch, d), dtype=f32, device=device),
            "m": torch.full((batch, d), -torch.inf, dtype=f32,
                            device=device)}
