"""gemma3-12b — 5:1 local:global attention interleave (port of
``repro/configs/gemma3_12b.py``).

48L d_model=3840 16H (GQA kv=8, head_dim 256) d_ff=15360 vocab=262144.
Local layers use a 1024-token sliding window with RoPE theta 10k; every
sixth layer is global with theta 1M. QK-norm, sqrt(d) embedding scaling,
GeGLU and tied embeddings. Shapes only: weights are initialised at
random from a seed.
"""
from repro_torch.models.config import GLOBAL, Family, ModelConfig

ARCH_ID = "gemma3-12b"

LOCAL_WINDOW = 1024


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family=Family.DENSE,
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        window_pattern=(LOCAL_WINDOW,) * 5 + (GLOBAL,),
        qk_norm=True,
        scale_embeddings=True,
        act="gelu",
        rope_theta_global=1_000_000.0,
        rope_theta_local=10_000.0,
        tie_embeddings=True,
    )
