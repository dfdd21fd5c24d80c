"""Learning-rate schedules, callables of the () int32 step count (port of
``repro/optim/schedules.py``). Each returns a () float32 tensor on the
count's device."""
from __future__ import annotations

import math

import torch

from repro_torch.device import scalar


def constant(lr: float):
    return lambda count: scalar(lr, count.device)


def cosine_decay(lr: float, decay_steps: int, final_fraction: float = 0.1):
    def fn(count):
        frac = torch.clamp(count.to(torch.float32) / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return lr * (final_fraction + (1 - final_fraction) * cos)

    return fn


def linear_warmup_cosine(
    lr: float, warmup_steps: int, decay_steps: int, final_fraction: float = 0.1
):
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), final_fraction)

    def fn(count):
        c = count.to(torch.float32)
        warm = lr * c / max(warmup_steps, 1)
        return torch.where(c < warmup_steps, warm, cos(count - warmup_steps))

    return fn
