"""mixtral-8x7b — 8 experts top-2, sliding-window attention (port of
``repro/configs/mixtral_8x7b.py``).

32L d_model=4096 32H (GQA kv=8, head_dim 128) per-expert d_ff=14336
vocab=32000, MoE 8e top-2, SWA window 4096 on every layer. Shapes only:
weights are initialised at random from a seed.
"""
from repro_torch.models.config import Family, ModelConfig

ARCH_ID = "mixtral-8x7b"

SWA_WINDOW = 4096


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family=Family.MOE,
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        num_experts=8,
        experts_per_token=2,
        window_pattern=(SWA_WINDOW,),
        rope_theta_global=1_000_000.0,
    )
