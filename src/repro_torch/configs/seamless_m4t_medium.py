"""seamless-m4t-medium — encoder-decoder multimodal backbone (port of
``repro/configs/seamless_m4t_medium.py``). [arXiv:2308.11596]

12L encoder + 12L decoder, d_model=1024 16H (kv=16, head_dim 64)
d_ff=4096 vocab=256206. The speech/text frontend is a stub, as in the
JAX package: the encoder takes precomputed frame embeddings
(B, S_src, d_model). Shapes only: weights are initialised at random from
a seed.
"""
from repro_torch.models.config import Family, ModelConfig

ARCH_ID = "seamless-m4t-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family=Family.ENCDEC,
        num_layers=12,
        num_encoder_layers=12,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256206,
        embed_frontend_fraction=1.0,
    )
