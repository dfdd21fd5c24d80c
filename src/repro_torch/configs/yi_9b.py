"""yi-9b — llama-architecture dense GQA (port of ``repro/configs/yi_9b.py``).

48L d_model=4096 32H (GQA kv=4, head_dim 128) d_ff=11008 vocab=64000.
Full causal attention. Shapes only: weights are initialised at random
from a seed.
"""
from repro_torch.models.config import Family, ModelConfig

ARCH_ID = "yi-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family=Family.DENSE,
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        rope_theta_global=5_000_000.0,
    )
