"""rwkv6-1.6b ("Finch") — attention-free, data-dependent decay (port of
``repro/configs/rwkv6_1_6b.py``). [arXiv:2404.05892]

24L d_model=2048 (32 wkv heads of 64) d_ff=7168 vocab=65536, untied LM
head. Shapes only: weights are initialised at random from a seed.
"""
from repro_torch.models.config import Family, ModelConfig

ARCH_ID = "rwkv6-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family=Family.SSM,
        num_layers=24,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=7168,
        vocab_size=65536,
    )
