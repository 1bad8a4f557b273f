"""Model configuration (a copy of ``repro.models.config``, pure Python): one
dataclass covering all 10 assigned architectures.  The port runs every block
type below, so all ten (``repro_torch.configs.ARCHS``).

A model is a list of *stacks*; each stack is a repeating *unit* of block types
scanned ``repeats`` times (params stacked on a leading repeat axis, O(1) HLO
size in depth).  Block types:

  attn          -- global causal GQA self-attention
  local         -- sliding-window causal GQA self-attention (cfg.window)
  cross         -- cross-attention to ``memory`` (vision patches / enc output)
  self+cross    -- decoder layer with self-attn then cross-attn (whisper dec)
  enc           -- bidirectional self-attention (whisper encoder)
  moe           -- attention + MoE FFN layer (cfg.moe)
  rglru         -- RecurrentGemma recurrent block (conv + RG-LRU)
  mlstm / slstm -- xLSTM blocks

Each unit position carries its own parameters; every non-recurrent block is
(norm -> mixer -> residual, norm -> ffn -> residual) unless the family says
otherwise (moe replaces the ffn; xlstm blocks have no separate ffn).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int           # per-expert FFN hidden dim
    dense_residual: bool = False   # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | vlm | hybrid | ssm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    stacks: Sequence[tuple[tuple[str, ...], int]]   # [(unit, repeats), ...]
    head_dim: Optional[int] = None  # default d_model // n_heads
    window: int = 1024              # sliding window for `local` blocks
    rope_theta: float = 10_000.0
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    qk_norm: bool = False                   # qwen3
    post_norm: bool = False                 # gemma2/3 sandwich norms
    emb_scale: Optional[float] = None       # gemma: sqrt(d); minicpm: 12
    logit_scale: Optional[float] = None     # minicpm: 1/(d/256)
    residual_scale: Optional[float] = None  # minicpm: 1.4/sqrt(L)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    # enc-dec / multimodal frontends (STUBS: precomputed embeddings as inputs)
    encoder_stacks: Sequence[tuple[tuple[str, ...], int]] = ()
    memory_len: int = 0            # vision tokens / encoder frames fed to `cross`
    # serving
    supports_long_context: bool = False   # sub-quadratic / windowed; runs long_500k
    # RG-LRU / xLSTM dims
    rglru_expand: float = 1.5       # recurrent width = expand * d_model (griffin: 4/3..1.5)
    conv_width: int = 4
    mlstm_expand: float = 2.0
    slstm_proj: float = 4.0 / 3.0
    mlstm_chunk: int = 256

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return sum(len(u) * r for u, r in self.stacks) + \
               sum(len(u) * r for u, r in self.encoder_stacks)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND."""
        d, hd = self.d_model, self.hd
        n = self.vocab * d * (1 if self.tie_embeddings else 2)

        def block_params(btype: str) -> int:
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + \
                   self.n_heads * hd * d
            ffn = 3 * d * self.d_ff
            if btype in ("attn", "local", "enc"):
                return attn + ffn
            if btype == "cross":
                return attn + ffn
            if btype == "self+cross":
                return 2 * attn + ffn
            if btype == "moe":
                m = self.moe
                e = m.n_experts * 3 * d * m.d_expert
                dense = ffn if m.dense_residual else 0
                return attn + e + dense
            if btype == "rglru":
                w = int(self.rglru_expand * d)
                return 2 * d * w + self.conv_width * w + 3 * w + w * d + ffn
            if btype == "mlstm":
                w = int(self.mlstm_expand * d)
                return 2 * d * w + 3 * w * w // max(1, self.n_heads) + w * d
            if btype == "slstm":
                w = d
                return 4 * d * w + int(self.slstm_proj * d) * d * 2
            raise ValueError(btype)

        for stacks in (self.stacks, self.encoder_stacks):
            for unit, r in stacks:
                for bt in unit:
                    n += r * block_params(bt)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        m = self.moe
        d = self.d_model
        per_layer_all = m.n_experts * 3 * d * m.d_expert
        per_layer_active = m.top_k * 3 * d * m.d_expert
        n_moe_layers = sum(r * sum(1 for b in u if b == "moe")
                           for u, r in self.stacks)
        return full - n_moe_layers * (per_layer_all - per_layer_active)


def simple_decoder(name: str, n_layers: int, d_model: int, n_heads: int,
                   n_kv: int, d_ff: int, vocab: int, **kw) -> ModelConfig:
    return ModelConfig(name=name, family=kw.pop("family", "dense"),
                       d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                       d_ff=d_ff, vocab=vocab,
                       stacks=((("attn",), n_layers),), **kw)
