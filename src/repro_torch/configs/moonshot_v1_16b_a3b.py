"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6 (port of
``repro/configs/moonshot_v1_16b_a3b.py``).

48L d_model=2048 16H (kv=16, head_dim 128) per-expert d_ff=1408
vocab=163840, MoE 64e top-6. Full attention. Shapes only: weights are
initialised at random from a seed.
"""
from repro_torch.models.config import Family, ModelConfig

ARCH_ID = "moonshot-v1-16b-a3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family=Family.MOE,
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163840,
        num_experts=64,
        experts_per_token=6,
        rope_theta_global=50_000.0,
    )
