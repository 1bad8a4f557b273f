"""minicpm-2b [dense]: 40L llama-like with depth/width mu-P-style scaling and
the WSD schedule (train/schedules.py) [arXiv:2404.06395; hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab=122753,
        stacks=((("attn",), 40),),
        emb_scale=12.0, logit_scale=256.0 / 2304.0,
        residual_scale=1.4 / 40 ** 0.5,
        tie_embeddings=True,
    )
