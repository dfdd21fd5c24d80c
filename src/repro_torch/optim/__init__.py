from repro_torch.optim.optimizers import (
    OptState,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    sgdm,
)
from repro_torch.optim.schedules import constant, cosine_decay, linear_warmup_cosine

__all__ = [
    "OptState",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "constant",
    "cosine_decay",
    "global_norm",
    "linear_warmup_cosine",
    "sgdm",
]
