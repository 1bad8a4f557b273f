"""recurrentgemma-9b [hybrid]: 38L, RG-LRU + local attention 2:1
[arXiv:2402.19427 (Griffin); pool tier: unverified]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab=256000,
        # 38 layers = 12 x (rglru, rglru, local) + 2 rglru tail
        stacks=((("rglru", "rglru", "local"), 12), (("rglru",), 2)),
        window=2048, rglru_expand=1.0,
        emb_scale=4096 ** 0.5, tie_embeddings=True,
        supports_long_context=True,   # recurrent state is O(1) in seq
    )
