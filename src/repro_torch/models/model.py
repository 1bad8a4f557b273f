"""The port's model: init / forward / prefill / decode / loss (port of
``repro.models.model``) for every block type: decoder-only stacks, untied
embeddings, encoder stacks run over a memory (whisper's audio frames) and
cross-attention to it (llama-vision's patches, whisper's encoder output),
MoE (single-device, and expert-parallel under a mesh), the RG-LRU and the
xLSTM pair.

Parameters are nested dicts of tensors whose paths follow the reference's:
the reference stacks a unit's layers on a leading repeat axis
(``params["stacks"]["s0"]["b1"]["rec"]["wx"]`` of shape (R, d, w)) and scans
over it; the port keeps one dict per layer in a list
(``params["stacks"]["s0"][r]["b1"]["rec"]["wx"]`` of shape (d, w)) and runs
the layers in a Python loop.  Under ``activation_sharding(mesh)`` the
parameters are DTensors, and each layer gathers its own just before it
computes (``act_ctx.materialize``; the embedding, unembedding and final
norms once a call), as the reference's layers read their shards through
GSPMD, except that the attention, MLP, MoE, RG-LRU and xLSTM blocks keep
the ``model`` shard of the weights they split, and the embedding and
unembedding their share of the vocabulary (``models/tensor_parallel.py``);
each rank runs its own batch rows.  The caches come placed too, and each
block reads from their placements which shard of each leaf is its own.

Under a vocabulary split over ``model`` (a mesh whose ``model`` axis is
larger than 1 and divides the vocabulary) the logits that :func:`forward`,
:func:`prefill` and :func:`decode_step` return are this rank's columns,
ids ``[lo, lo + V / tp)``: they are never gathered.  Their callers take
the shard: ``serve/step.py`` picks through ``tensor_parallel.argmax``, and
:func:`loss_fn` computes its own chunks' logits and
``tensor_parallel.vocab_cross_entropy``.  Elsewhere the logits are whole.
Where autograd records a train-mode forward, each layer runs under
``torch.utils.checkpoint`` (the reference's per-layer ``jax.checkpoint``)
unless ``remat=False``.  ``enc_stacks`` and caches have the same layout.
``models/convert.py`` carries the reference's parameters over.

Entry points take ``device=None``, which means the CUDA card and raises
without one; the tests pass ``device="cpu"``.  Random parameters come from a
``torch.Generator`` seeded from an int: they are not the reference's
``jax.random`` draws.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.index.engine import resolve_device
from repro_torch.tree import tree_leaves

from . import act_ctx, blocks, tensor_parallel
from .act_ctx import activation_sharding  # noqa: F401  (as the reference)
from .blocks import Ctx
from .config import ModelConfig

Params = Any

# ------------------------------------------------------------------ init
def init_block(btype: str, cfg: ModelConfig, dense: blocks.Dense,
               dtype: torch.dtype, device) -> dict:
    d = cfg.d_model

    def ln():
        return torch.zeros((d,), dtype=dtype, device=device)

    def attn():
        return blocks.init_attention(cfg, dense, dtype, device)

    if btype in ("attn", "local", "enc", "cross"):
        p = {"ln1": ln(), "attn": attn(),
             "ln2": ln(), "mlp": blocks.init_mlp(cfg, dense, dtype)}
    elif btype == "self+cross":
        p = {"ln1": ln(), "attn": attn(), "lnc": ln(), "xattn": attn(),
             "ln2": ln(), "mlp": blocks.init_mlp(cfg, dense, dtype)}
    elif btype == "moe":
        p = {"ln1": ln(), "attn": attn(),
             "ln2": ln(), "moe": blocks.init_moe(cfg, dense, dtype)}
    elif btype == "rglru":
        p = {"ln1": ln(), "rec": blocks.init_rglru(cfg, dense, dtype, device),
             "ln2": ln(), "mlp": blocks.init_mlp(cfg, dense, dtype)}
    elif btype == "mlstm":
        p = {"ln1": ln(), "mix": blocks.init_mlstm(cfg, dense, dtype)}
    elif btype == "slstm":
        p = {"ln1": ln(), "mix": blocks.init_slstm(cfg, dense, dtype)}
    else:
        raise ValueError(btype)
    if cfg.post_norm and btype not in ("mlstm", "slstm"):
        p["ln1p"] = ln()
        p["ln2p"] = ln()
    return p


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device=None) -> Params:
    """Random parameters, N(0, 0.02) weights and zero norms as in the
    reference, drawn on ``device`` from a generator seeded with ``seed``.
    ``device="meta"`` gives shapes only (see :func:`param_count`)."""
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)

    def dense(shape, dt):
        t = torch.empty(shape, dtype=dt, device=dev)
        return t.normal_(0.0, 0.02, generator=gen)

    def norm():
        return torch.zeros((cfg.d_model,), dtype=dtype, device=dev)

    def stacks(spec):
        return {f"s{si}": [{f"b{bi}": init_block(bt, cfg, dense, dtype, dev)
                            for bi, bt in enumerate(unit)}
                           for _ in range(r)]
                for si, (unit, r) in enumerate(spec)}

    params = {"embed": dense((cfg.vocab, cfg.d_model), dtype),
              "final_norm": norm(), "stacks": stacks(cfg.stacks)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense((cfg.d_model, cfg.vocab), dtype)
    if cfg.encoder_stacks:
        params["enc_stacks"] = stacks(cfg.encoder_stacks)
        params["enc_final_norm"] = norm()
    return params


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count, from shapes alone (no allocation)."""
    shapes = init_params(cfg, device="meta")
    return sum(t.numel() for t in tree_leaves(shapes))


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token: the full count less the experts a
    token is not routed to."""
    n = param_count(cfg)
    if cfg.moe is None:
        return n
    m = cfg.moe
    per_layer_inactive = (m.n_experts - m.top_k) * 3 * cfg.d_model * m.d_expert
    n_moe = sum(r * sum(1 for b in u if b == "moe") for u, r in cfg.stacks)
    return n - n_moe * per_layer_inactive


def param_bytes(params: Params) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


# ------------------------------------------------------------------ blocks
def apply_block(btype: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
                ctx: Ctx):
    scale = cfg.residual_scale if cfg.residual_scale is not None else 1.0
    eps = cfg.norm_eps

    def residual(x, h, post_key):
        if cfg.post_norm and post_key in p:
            h = blocks.rmsnorm(p[post_key], h, eps)
        return x + scale * h

    if btype in ("attn", "local", "enc", "moe"):
        h = blocks.rmsnorm(p["ln1"], x, eps)
        h, cache = blocks.apply_attention(
            p["attn"], h, cfg, ctx, causal=(btype != "enc"),
            window=cfg.window if btype == "local" else None)
        x = residual(x, h, "ln1p")
        h = blocks.rmsnorm(p["ln2"], x, eps)
        h = blocks.apply_moe(p["moe"], h, cfg) if btype == "moe" else \
            blocks.apply_mlp(p["mlp"], h)
        x = residual(x, h, "ln2p")
        return x, cache
    if btype == "cross":
        h = blocks.rmsnorm(p["ln1"], x, eps)
        h, cache = blocks.apply_attention(p["attn"], h, cfg, ctx, cross=True)
        x = residual(x, h, "ln1p")
        h = blocks.rmsnorm(p["ln2"], x, eps)
        x = residual(x, blocks.apply_mlp(p["mlp"], h), "ln2p")
        return x, cache
    if btype == "self+cross":
        # whisper's decoder layer: no post-norms, as in the reference
        sub_self = Ctx(ctx.mode, ctx.pos, ctx.memory,
                       None if ctx.cache is None else ctx.cache["self"])
        h = blocks.rmsnorm(p["ln1"], x, eps)
        h, c_self = blocks.apply_attention(p["attn"], h, cfg, sub_self)
        x = x + scale * h
        sub_x = Ctx(ctx.mode, ctx.pos, ctx.memory,
                    None if ctx.cache is None else ctx.cache["cross"])
        h = blocks.rmsnorm(p["lnc"], x, eps)
        h, c_cross = blocks.apply_attention(p["xattn"], h, cfg, sub_x,
                                            cross=True)
        x = x + scale * h
        h = blocks.rmsnorm(p["ln2"], x, eps)
        x = x + scale * blocks.apply_mlp(p["mlp"], h)
        cache = None if ctx.cache is None and ctx.mode == "train" else \
            {"self": c_self, "cross": c_cross}
        return x, cache
    if btype == "rglru":
        h = blocks.rmsnorm(p["ln1"], x, eps)
        h, cache = blocks.apply_rglru(p["rec"], h, cfg, ctx)
        x = x + scale * h
        h = blocks.rmsnorm(p["ln2"], x, eps)
        x = x + scale * blocks.apply_mlp(p["mlp"], h)
        return x, cache
    if btype in ("mlstm", "slstm"):
        h = blocks.rmsnorm(p["ln1"], x, eps)
        apply = blocks.apply_mlstm if btype == "mlstm" else blocks.apply_slstm
        h, cache = apply(p["mix"], h, cfg, ctx)
        return x + scale * h, cache
    raise ValueError(btype)


_SELF_GATHERED = ("attn", "xattn", "mlp", "moe", "rec", "mix")


def _layer_params(lp: dict) -> dict:
    """One layer's parameters as its blocks compute with them: under a mesh
    gathered into local tensors (``act_ctx.materialize``), except the
    attention, MLP, MoE, RG-LRU and xLSTM blocks', which
    ``blocks.apply_attention``, ``apply_mlp``, ``apply_moe``,
    ``apply_rglru``, ``apply_mlstm`` and ``apply_slstm`` gather themselves:
    each keeps the ``model`` shard of the weights it splits
    (``models/tensor_parallel``).  Under ``zero3`` with ``model`` carrying
    no rows, those blocks' weights are gathered whole here and handed on as
    ``act_ctx.model_views``, which read as the ``2d`` placements.
    A checkpointed unit calls this again when it is recomputed, and its
    blocks split as they did the first time."""
    if act_ctx.mesh() is None:
        return lp
    return {bk: {k: act_ctx.model_views(v) if k in _SELF_GATHERED
                 else act_ctx.materialize(v)
                 for k, v in bp.items()} for bk, bp in lp.items()}


# the vocabulary's dim of each leaf that holds it
_VOCAB_DIM = {"embed": 0, "unembed": 1}


def _top_params(params: Params) -> Params:
    """``params`` with the embedding, unembedding and final norms gathered
    under a mesh (the stacks are gathered a layer at a time).  Where their
    placements split the vocabulary over ``model`` (``tensor_parallel``;
    under ``zero3``, their ``act_ctx.model_views``), ``embed`` and
    ``unembed`` keep that shard: rows of ``embed``, columns of
    ``unembed``."""
    if act_ctx.mesh() is None:
        return params
    top = act_ctx.model_views({k: v for k, v in params.items()
                               if k not in ("stacks", "enc_stacks")})
    keep = tuple(k for k, dim in _VOCAB_DIM.items() if k in top
                 and tensor_parallel.size() > 1
                 and act_ctx.model_split_dim(top[k]) == dim)
    return {**params, **tensor_parallel.shards(top, keep=keep)}


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor
           ) -> torch.Tensor:
    """The tokens' rows of ``embed``: through ``tensor_parallel``'s lookup
    where this rank holds a share of the vocabulary."""
    table = params["embed"]
    lo = tensor_parallel.vocab_offset(table.shape[0], cfg.vocab)
    return table[tokens] if lo is None else \
        tensor_parallel.vocab_lookup(tokens, table, lo)


def _apply_unit(x: torch.Tensor, unit, lp: dict, lc, cfg: ModelConfig,
                ctx_proto: Ctx):
    """One repeat of a unit: its blocks in order.  Returns (x, caches).
    Under a mesh its parameters are gathered here, so that a checkpointed
    layer gathers them again when it is recomputed."""
    x = act_ctx.constrain_btd(x)
    lp = _layer_params(lp)
    ncs = {}
    for bi, bt in enumerate(unit):
        ctx = Ctx(ctx_proto.mode, ctx_proto.pos, ctx_proto.memory,
                  None if lc is None else lc[f"b{bi}"])
        x, ncs[f"b{bi}"] = apply_block(bt, lp[f"b{bi}"], x, cfg, ctx)
    return act_ctx.constrain_btd(x), ncs


def _unit_hidden(x, unit, lp, cfg, ctx_proto) -> torch.Tensor:
    return _apply_unit(x, unit, lp, None, cfg, ctx_proto)[0]


def _run_stacks(stack_params, stacks, x, cfg: ModelConfig, ctx_proto: Ctx,
                caches, remat: bool = False):
    """Every layer in order, a Python loop (the reference scans each
    stack); returns the hidden state and the new caches, same layout.
    ``remat``: where autograd is recording, each layer (one repeat of the
    unit) runs under ``torch.utils.checkpoint`` and keeps no caches (the
    train mode's, which ``forward`` drops)."""
    new_caches = {}
    for si, (unit, r) in enumerate(stacks):
        layers = stack_params[f"s{si}"]
        out = []
        for li in range(r):
            if remat and torch.is_grad_enabled():
                x = checkpoint(_unit_hidden, x, unit, layers[li], cfg,
                               ctx_proto, use_reentrant=False)
                ncs = {f"b{bi}": None for bi in range(len(unit))}
            else:
                lc = None if caches is None else caches[f"s{si}"][li]
                x, ncs = _apply_unit(x, unit, layers[li], lc, cfg, ctx_proto)
            out.append(ncs)
        new_caches[f"s{si}"] = out
    return x, new_caches


# ------------------------------------------------------------------ forward
def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            memory: Optional[torch.Tensor] = None, mode: str = "train",
            pos: Optional[torch.Tensor] = None, caches=None, enc_caches=None,
            remat: bool = True, return_hidden: bool = False):
    """Returns (logits, new_caches).  tokens: (B, T) integer.  Under a
    vocabulary split the logits are this rank's columns (the module
    docstring names their callers).

    ``memory``: precomputed frontend embeddings (B, M, D), vision patches
    (vlm) or audio frames (audio); run through the encoder stacks, in
    train mode, where the config has them.  ``enc_caches``: an encoder
    output computed before, used as the memory as it is.
    ``mode="train"`` is the cache-free forward; under autograd with
    ``remat`` (the default, as in the reference) each layer is
    checkpointed.  Without autograd (serving, the consistency checks)
    ``remat`` changes nothing."""
    b, t = tokens.shape
    params = _top_params(params)
    x = _embed(params, cfg, tokens)
    if cfg.emb_scale is not None:
        x = x * torch.tensor(cfg.emb_scale, dtype=x.dtype, device=x.device)
    x = act_ctx.constrain_btd(x)
    if pos is None:
        pos = torch.arange(t, dtype=torch.int32,
                           device=tokens.device)[None].expand(b, t)

    if cfg.encoder_stacks and memory is not None and enc_caches is None:
        mpos = torch.arange(memory.shape[1], dtype=torch.int32,
                            device=memory.device)[None].expand(
                                memory.shape[0], -1)
        memory, _ = _run_stacks(params["enc_stacks"], cfg.encoder_stacks,
                                memory, cfg, Ctx("train", mpos), None,
                                remat=(mode == "train"))
        memory = blocks.rmsnorm(params["enc_final_norm"], memory,
                                cfg.norm_eps)
    elif enc_caches is not None:
        memory = enc_caches                     # precomputed encoder output

    ctx = Ctx(mode, pos, memory)
    x, new_caches = _run_stacks(params["stacks"], cfg.stacks, x, cfg, ctx,
                                caches, remat=(mode == "train" and remat))
    x = blocks.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    caches_out = new_caches if mode != "train" else None
    if return_hidden:
        return x, caches_out
    return unembed(params, cfg, x), caches_out


def unembed(params: Params, cfg: ModelConfig, x: torch.Tensor
            ) -> torch.Tensor:
    """The logits of hidden states ``x``: this rank's columns where it holds
    a share of the vocabulary (its ``x`` entering the split region through
    ``tensor_parallel.copy``), else all of them."""
    un = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    if un.shape[1] != cfg.vocab:
        x = tensor_parallel.copy(x)
    logits = blocks.mm(x, un)
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


LOSS_CHUNK = 512  # sequence chunk for the vocab projection + xent


def _chunk_nll(params: Params, cfg: ModelConfig, h_c: torch.Tensor,
               y_c: torch.Tensor, w_c: torch.Tensor) -> torch.Tensor:
    logits = unembed(params, cfg, act_ctx.constrain_btd(h_c)).float()
    lo = tensor_parallel.vocab_offset(logits.shape[-1], cfg.vocab)
    if lo is not None:
        nll = tensor_parallel.vocab_cross_entropy(logits, y_c, lo)
        return torch.sum(nll * w_c[None, :])
    if act_ctx.mesh() is not None and "model" not in act_ctx.dp_axes():
        logits = act_ctx.constrain(logits,
                                   (act_ctx.dp_axes(), None, "model"))
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, y_c[..., None])[..., 0]
    return -torch.sum(ll * w_c[None, :])


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            memory: Optional[torch.Tensor] = None, remat: bool = True
            ) -> torch.Tensor:
    """Next-token cross entropy (the reference's ``loss_fn``), chunked over
    the sequence so that the (B, C, V) logits of only one chunk are ever
    live: each chunk's unembedding and log-softmax run under
    ``torch.utils.checkpoint``.  Under a vocabulary split a chunk's logits
    are this rank's columns, and ``tensor_parallel.vocab_cross_entropy``
    combines the ranks' shares.  Labels are the tokens rolled by one; the
    last position, which has no next token, weighs 0; the mean is over
    ``b * (t - 1)``."""
    b, t1 = tokens.shape
    params = _top_params(params)
    hidden, _ = forward(params, cfg, tokens, memory=memory, mode="train",
                        remat=remat, return_hidden=True)
    labels = torch.roll(tokens, -1, dims=1).long()
    weights = torch.ones((t1,), dtype=torch.float32, device=tokens.device)
    weights[-1] = 0.0
    c = LOSS_CHUNK if t1 % LOSS_CHUNK == 0 else t1
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(t1 // c):
        cols = slice(i * c, (i + 1) * c)
        total = total + checkpoint(_chunk_nll, params, cfg, hidden[:, cols],
                                   labels[:, cols], weights[cols],
                                   use_reentrant=False)
    return total / (b * (t1 - 1))


# ------------------------------------------------------------------ caches
def init_block_cache(btype: str, cfg: ModelConfig, batch: int,
                     cache_len: int, dtype, device) -> dict:
    if btype in ("attn", "moe"):
        return blocks.init_attention_cache(cfg, batch, cache_len, dtype,
                                           device)
    if btype == "local":
        return blocks.init_attention_cache(cfg, batch,
                                           min(cfg.window, cache_len), dtype,
                                           device)
    if btype == "cross":
        shape = (batch, cfg.memory_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if btype == "self+cross":
        return {"self": init_block_cache("attn", cfg, batch, cache_len, dtype,
                                         device),
                "cross": init_block_cache("cross", cfg, batch, cache_len,
                                          dtype, device)}
    if btype == "rglru":
        return blocks.init_rglru_cache(cfg, batch, dtype, device)
    if btype == "mlstm":
        return blocks.init_mlstm_cache(cfg, batch, device)
    if btype == "slstm":
        return blocks.init_slstm_cache(cfg, batch, device)
    raise ValueError(btype)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                dtype=torch.bfloat16, device=None):
    """Per-layer caches, in the parameters' layout."""
    dev = resolve_device(device)
    return {f"s{si}": [{f"b{bi}": init_block_cache(bt, cfg, batch, cache_len,
                                                   dtype, dev)
                        for bi, bt in enumerate(unit)} for _ in range(r)]
            for si, (unit, r) in enumerate(cfg.stacks)}


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                pos: torch.Tensor, caches, memory=None, enc_out=None):
    """One decode step.  tokens: (B, 1); pos: (B,) absolute positions.
    Cross-attention reads its keys and values from the caches prefill
    wrote, so ``memory`` is not needed here (given, with encoder stacks,
    it runs the encoder again, as the reference does).  Its logits are
    :func:`forward`'s: this rank's columns under a vocabulary split."""
    return forward(params, cfg, tokens, memory=memory, mode="decode",
                   pos=pos[:, None], caches=caches, enc_caches=enc_out)


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor, caches,
            memory=None, last_only: bool = False):
    """last_only=True returns only the final position's logits (the serving
    path: a full (B, T, 256k-vocab) logits tensor is never needed); this
    rank's columns of them under a vocabulary split, as :func:`forward`'s."""
    params = _top_params(params)
    hidden, new_caches = forward(params, cfg, tokens, memory=memory,
                                 mode="prefill", caches=caches,
                                 return_hidden=True)
    if last_only:
        hidden = hidden[:, -1:]
    return unembed(params, cfg, hidden), new_caches
