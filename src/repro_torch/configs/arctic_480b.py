"""arctic-480b [moe]: 35L, 128-expert top-2 MoE in parallel with a dense
residual MLP (dense-MoE hybrid) [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe",
        d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=4864, vocab=32000,
        stacks=((("moe",), 35),),
        moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864,
                      dense_residual=True),
        tie_embeddings=False,
    )
