"""hymba-1.5b — hybrid parallel attention + Mamba heads per layer (port of
``repro/configs/hymba_1_5b.py``). [arXiv:2411.13676]

32L d_model=1600 25H (GQA kv=5, head_dim 64) d_ff=5504 vocab=32001,
ssm_state=16. Global attention only at the first, middle and last
layers; every other layer a 1,024-token sliding window. Hymba's
learnable meta tokens are omitted, as in the JAX package. Shapes only:
weights are initialised at random from a seed.
"""
from repro_torch.models.config import GLOBAL, Family, ModelConfig

ARCH_ID = "hymba-1.5b"

LOCAL_WINDOW = 1024
NUM_LAYERS = 32
_GLOBAL_LAYERS = (0, NUM_LAYERS // 2 - 1, NUM_LAYERS - 1)


def _pattern() -> tuple[int, ...]:
    return tuple(
        GLOBAL if i in _GLOBAL_LAYERS else LOCAL_WINDOW for i in range(NUM_LAYERS)
    )


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family=Family.HYBRID,
        num_layers=NUM_LAYERS,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        window_pattern=_pattern(),
        rope_theta_global=10_000.0,
    )
