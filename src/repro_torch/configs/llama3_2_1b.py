"""llama3.2-1b — small llama3 (port of ``repro/configs/llama3_2_1b.py``).

16L d_model=2048 32H (GQA kv=8, head_dim 64) d_ff=8192 vocab=128256.
Tied embeddings (as released). Shapes only: weights are initialised at
random from a seed.
"""
from repro_torch.models.config import Family, ModelConfig

ARCH_ID = "llama3.2-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family=Family.DENSE,
        num_layers=16,
        d_model=2048,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=128256,
        tie_embeddings=True,
        rope_theta_global=500_000.0,
    )
