"""whisper-medium [audio]: enc-dec, 24+24L; conv frontend is a STUB
(input_specs provides precomputed 1500-frame embeddings)
[arXiv:2212.04356; pool tier: unverified]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=51865,
        stacks=((("self+cross",), 24),),
        encoder_stacks=((("enc",), 24),),
        memory_len=1500, tie_embeddings=True,
    )
