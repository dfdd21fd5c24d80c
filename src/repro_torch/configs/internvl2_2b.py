"""internvl2-2b — InternViT frontend + InternLM2 backbone (port of
``repro/configs/internvl2_2b.py``). [arXiv:2404.16821]

24L d_model=2048 16H (GQA kv=8, head_dim 128) d_ff=8192 vocab=92553.
The ViT frontend is a stub, as in the JAX package: precomputed patch
embeddings are prepended to the text tokens. Shapes only: weights are
initialised at random from a seed.
"""
from repro_torch.models.config import Family, ModelConfig

ARCH_ID = "internvl2-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family=Family.VLM,
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        embed_frontend_fraction=0.125,
        rope_theta_global=1_000_000.0,
    )
