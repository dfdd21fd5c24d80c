"""Energy model + adaptive energy budgeting — paper Eq. 10 and §IV.F
(port of ``repro/core/energy.py``; see its docstring for the sign
convention of the Eq. 10 controller)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import Array

_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class EnergyModelConfig:
    c_cpu: float = 1e-9  # Joules per CPU cycle (sim units)
    c_tx: float = 5e-8  # Joules per transmitted byte
    lam: float = 0.3  # λ in Eq. 10
    theta_min: float = 0.05
    theta_max: float = 0.95
    cold_start_energy_j: float = 0.4  # e_c in §IV.F T_cold


def round_energy(
    cpu_cycles: Array, tx_bytes: Array, config: EnergyModelConfig
) -> Array:
    """§IV.F: per-client energy for one round, in Joules (sim units)."""
    return config.c_cpu * cpu_cycles.to(torch.float32) + config.c_tx * tx_bytes.to(
        torch.float32
    )


def decay_energy_threshold(
    theta_e: Array, energy_last_round: Array, config: EnergyModelConfig
) -> Array:
    """Eq. 10 exponential controller, clipped to [theta_min, theta_max]."""
    e_avg = torch.mean(energy_last_round) + _EPS
    factor = torch.exp(config.lam * (energy_last_round / e_avg - 1.0))
    return torch.clamp(theta_e * factor, config.theta_min, config.theta_max)


def paper_eq10_literal(theta_e: Array, energy_last_round: Array, lam: float) -> Array:
    """Eq. 10 exactly as printed: θ·exp(-λ·E_i/E_avg)."""
    e_avg = torch.mean(energy_last_round) + _EPS
    return theta_e * torch.exp(-lam * energy_last_round / e_avg)


def battery_drain(batt: Array, energy_j: Array, capacity_j: float) -> Array:
    """Deplete normalized battery level by this round's spend."""
    return torch.clamp(batt - energy_j / capacity_j, 0.0, 1.0)
