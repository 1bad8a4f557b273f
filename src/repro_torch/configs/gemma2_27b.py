"""gemma2-27b [dense]: 46L alternating local/global, logit softcaps
[arXiv:2408.00118; hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b", family="dense",
        d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=36864, vocab=256000,
        # 46 layers = 23 x (local + global)
        stacks=((("local", "attn"), 23),),
        window=4096, attn_softcap=50.0, final_softcap=30.0,
        post_norm=True, emb_scale=4608 ** 0.5, tie_embeddings=True,
        supports_long_context=True,   # half the layers are 4k-window local
    )
