"""Client churn and availability for the async engine (port of
``repro/sim/events/churn.py``).

Each client is a two-state continuous-time Markov process (online /
offline) with exponential holding times, stepped lazily at dispatch
times:

    P(depart in dt | online)  = 1 - exp(-departure_rate · dt)
    P(arrive in dt | offline) = 1 - exp(-arrival_rate  · dt)

with dt in virtual seconds. A client is available for dispatch when it is
online and its battery is above the death threshold. Rates of 0 (the
default) make ``step_churn`` the identity and draw nothing. The uniforms
come from the draw provider: ``churn.init`` once per run, ``churn`` once
per dispatch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Array = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    arrival_rate: float = 0.0  # offline→online events per virtual second
    departure_rate: float = 0.0  # online→offline events per virtual second
    death_batt: float = 0.05  # battery level below which a client is dead
    initial_online_frac: float = 1.0  # fraction online at t=0


def init_online(cfg: ChurnConfig, num_clients: int, draws) -> Array:
    """(N,) bool initial presence mask."""
    if cfg.initial_online_frac >= 1.0:
        return torch.ones((num_clients,), dtype=torch.bool, device=draws.device)
    u = draws.uniform("churn.init", (num_clients,), 0.0, 1.0)
    return u < float(np.float32(cfg.initial_online_frac))


def step_churn(cfg: ChurnConfig, online: Array, dt_ms: Array, draws, *,
               round: int) -> Array:
    """Advance the presence process by ``dt_ms`` virtual milliseconds with
    the ``churn`` uniforms of dispatch ``round``."""
    if cfg.arrival_rate == 0 and cfg.departure_rate == 0:
        return online
    dt_s = torch.clamp(dt_ms.to(torch.float32), min=0.0) * 1e-3
    p_depart = 1.0 - torch.exp(-cfg.departure_rate * dt_s)
    p_arrive = 1.0 - torch.exp(-cfg.arrival_rate * dt_s)
    u = draws.uniform("churn", tuple(online.shape), 0.0, 1.0, round=round)
    return torch.where(online, u >= p_depart, u < p_arrive)


def available_mask(cfg: ChurnConfig, online: Array, batt: Array) -> Array:
    """Online AND battery above the death threshold."""
    return online & (batt > cfg.death_batt)
