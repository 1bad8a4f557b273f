"""llama-3.2-vision-11b [vlm]: 40L decoder, cross-attn to vision patches every
5th layer; vision frontend is a STUB (input_specs provides patch embeddings)
[hf:meta-llama/Llama-3.2-11B-Vision; pool tier: unverified]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256,
        # 40 layers = 8 x (4 self + 1 cross)
        stacks=((("attn",) * 4 + ("cross",), 8),),
        memory_len=1600,    # precomputed vision patch embeddings (stub)
        rope_theta=500_000.0, tie_embeddings=False,
    )
