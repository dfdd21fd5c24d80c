"""qwen2.5-14b — dense GQA with QKV bias (port of
``repro/configs/qwen2_5_14b.py``).

48L d_model=5120 40H (GQA kv=8, head_dim 128) d_ff=13824 vocab=152064.
Full causal attention. Shapes only: weights are initialised at random
from a seed.
"""
from repro_torch.models.config import Family, ModelConfig

ARCH_ID = "qwen2.5-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family=Family.DENSE,
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta_global=1_000_000.0,
    )
