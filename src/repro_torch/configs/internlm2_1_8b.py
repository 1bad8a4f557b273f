"""internlm2-1.8b [dense]: 24L GQA kv=8 [arXiv:2403.17297; hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="dense",
        d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=8192, vocab=92544,
        stacks=((("attn",), 24),),
        rope_theta=1_000_000.0, tie_embeddings=False,
    )
