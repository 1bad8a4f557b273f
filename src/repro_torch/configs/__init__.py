"""Architectures the port runs, as selectable configs (port of
``repro.configs``).

Each ``<id>.py`` module exports ``config() -> ModelConfig`` with the exact
pool dimensions.  ``reduced(cfg)`` shrinks a config to a CPU-test size of the
same family (same block pattern, tiny dims).  ``SHAPES`` is the reference's
input-shape set.  ``ARCHS`` lists what the port runs: all ten of the
reference's architectures.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, MoEConfig

ARCHS = [
    "gemma3-12b", "internlm2-1.8b", "gemma2-27b", "minicpm-2b", "arctic-480b",
    "qwen3-moe-235b-a22b", "llama-3.2-vision-11b", "recurrentgemma-9b",
    "xlstm-350m", "whisper-medium",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; the port runs "
                         f"{ARCHS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}")
    return mod.config()


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason).  long_500k needs sub-quadratic / windowed attention."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention architecture: O(seq) KV at 500k "
                       "decode exceeds any per-chip budget without windowed/"
                       "recurrent layers (DESIGN.md Sec. 4 skip list)")
    return True, ""


def reduced(cfg: ModelConfig, vocab: int = 512) -> ModelConfig:
    """Same family/pattern, smoke-test dims (runs on one CPU core)."""
    moe = None
    if cfg.moe is not None:
        # capacity_factor 4.0: at smoke batch sizes the statistical routing
        # balance doesn't hold, so give headroom to avoid token drops
        moe = MoEConfig(n_experts=4, top_k=min(2, cfg.moe.top_k), d_expert=64,
                        dense_residual=cfg.moe.dense_residual,
                        capacity_factor=4.0)
    shrink = lambda stacks: tuple((unit, min(r, 2)) for unit, r in stacks)
    return dataclasses.replace(
        cfg,
        d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) if
        cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16, d_ff=128, vocab=vocab,
        stacks=shrink(cfg.stacks),
        encoder_stacks=shrink(cfg.encoder_stacks),
        window=8, moe=moe, memory_len=16 if cfg.memory_len else 0,
        residual_scale=cfg.residual_scale if cfg.residual_scale is None
        else 0.25,
    )
