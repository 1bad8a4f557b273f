"""qwen3-moe-235b-a22b [moe]: 94L, 128-expert top-8, qk-norm
[hf:Qwen/Qwen3-235B-A22B family]."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab=151936,
        stacks=((("moe",), 94),),
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
        qk_norm=True, rope_theta=1_000_000.0,
        tie_embeddings=False,
    )
