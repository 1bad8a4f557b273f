"""xlstm-350m [ssm]: 24L sLSTM+mLSTM blocks (1 sLSTM per 4)
[arXiv:2405.04517; pool tier: unverified]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", family="ssm",
        d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304,
        # 24 layers = 6 x (m, m, m, s)
        stacks=((("mlstm", "mlstm", "mlstm", "slstm"), 6),),
        mlstm_expand=2.0, slstm_proj=4.0 / 3.0,
        tie_embeddings=True,
        supports_long_context=True,   # recurrent state is O(1) in seq
    )
