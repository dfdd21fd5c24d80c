"""Cold-start delay model — paper Eq. 4 + container cache (port of
``repro/core/coldstart.py``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import Array
from repro_torch.device import scalar


@dataclasses.dataclass(frozen=True)
class ColdStartConfig:
    delta_cold_ms: float = 2000.0  # paper §III.G worked example
    delta_warm_ms: float = 200.0
    keep_alive_rounds: int = 3
    warm_capacity: int | None = None  # max simultaneously-warm containers


def invocation_delay(warm: Array, config: ColdStartConfig) -> Array:
    """Eq. 4: per-client delay in ms given current container state."""
    return torch.where(
        warm,
        scalar(config.delta_warm_ms, warm.device),
        scalar(config.delta_cold_ms, warm.device),
    )


def count_cold_starts(mask: Array, warm: Array) -> Array:
    """Number of selected clients paying δ_cold this round."""
    return torch.sum((mask & ~warm).to(torch.int32))


def update_container_cache(
    warm: Array,
    last_used: Array,
    mask: Array,
    round_index: Array,
    config: ColdStartConfig,
) -> tuple[Array, Array]:
    """Advance the container cache one round -> (new_warm, new_last_used)."""
    new_last_used = torch.where(mask, round_index, last_used).to(torch.int32)
    age = round_index - new_last_used
    within_keep_alive = (new_last_used >= 0) & (age < config.keep_alive_rounds)
    new_warm = mask | (warm & within_keep_alive)
    if config.warm_capacity is not None:
        # LRU eviction: keep the `warm_capacity` most-recently-used warm
        # containers (stable sort on recency, like the JAX package).
        recency = torch.where(
            new_warm, new_last_used, torch.full_like(new_last_used, -2**30)
        )
        order = torch.argsort(-recency, stable=True)
        rank = torch.empty_like(order)
        rank[order] = torch.arange(order.shape[0], device=order.device)
        new_warm = new_warm & (rank < config.warm_capacity)
    return new_warm, new_last_used
