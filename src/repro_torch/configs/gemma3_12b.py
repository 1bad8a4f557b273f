"""gemma3-12b [dense]: 48L, 5:1 local:global, GQA kv=8, 128k ctx
[hf:google/gemma-3-12b family; pool entry verified-tier: unverified]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
        d_ff=15360, vocab=262144,
        # 48 layers = 8 x (5 local + 1 global)
        stacks=((("local",) * 5 + ("attn",), 8),),
        window=1024, rope_theta=1_000_000.0,
        qk_norm=True, post_norm=True,
        emb_scale=3840 ** 0.5, tie_embeddings=True,
        supports_long_context=True,   # 5:1 local design targets 128k+
    )
