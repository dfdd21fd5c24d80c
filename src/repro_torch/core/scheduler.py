"""FedFogScheduler — composes Eqs. 1/2/3/4/7/10 into one decision
(port of ``repro/core/scheduler.py``).

Stateless logic over explicit state (``SchedulerState``), so a round can
carry it from one call to the next with no hidden state.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import coldstart as cs
from repro_torch.core import drift as drift_mod
from repro_torch.core import energy as energy_mod
from repro_torch.core.health import health_score
from repro_torch.core.selection import select_clients
from repro_torch.core.types import (
    Array,
    ClientTelemetry,
    SchedulerState,
    SchedulerWeights,
    SelectionResult,
    Thresholds,
)
from repro_torch.device import scalar


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    # Paper defaults: §III.I adopts (θ_h, θ_e, θ_d) = (0.6, 0.5, 0.1);
    # §III.G worked example uses α=(0.4,0.3,0.3), β=(0.4,0.4,0.2).
    alpha: tuple[float, float, float] = (0.4, 0.3, 0.3)
    beta: tuple[float, float, float] = (0.4, 0.4, 0.2)
    theta_h: float = 0.6
    theta_e: float = 0.5
    theta_d: float = 0.1
    top_k: int | None = None  # participation budget per round
    adaptive_energy: bool = True  # Eq. 10 controller on/off (ablation knob)
    drift_gating: bool = True  # drift gate on/off (ablation knob)
    health_gating: bool = True  # health gate on/off (ablation knob)
    cold_start: cs.ColdStartConfig = dataclasses.field(
        default_factory=cs.ColdStartConfig
    )
    energy_model: energy_mod.EnergyModelConfig = dataclasses.field(
        default_factory=energy_mod.EnergyModelConfig
    )

    def weights(self, device) -> SchedulerWeights:
        """α and β as float32 vectors on ``device``: a copy from the host,
        so a caller that schedules many rounds builds them once and passes
        them to :func:`schedule_round`."""
        return SchedulerWeights(
            alpha=torch.tensor(self.alpha, dtype=torch.float32, device=device),
            beta=torch.tensor(self.beta, dtype=torch.float32, device=device),
        )


@dataclasses.dataclass(frozen=True)
class RoundDecision:
    """Everything the runtime needs to execute one FL round."""

    selection: SelectionResult
    delays_ms: Array  # (N,) Eq. 4 per-client invocation delay
    cold_starts: Array  # () int32 — selected clients paying δ_cold
    new_state: SchedulerState


def schedule_round(
    state: SchedulerState,
    telemetry: ClientTelemetry,
    current_hist: Array,
    config: SchedulerConfig,
    weights: SchedulerWeights | None = None,
) -> RoundDecision:
    """One scheduling decision over the full client registry. ``weights``
    are ``config.weights`` on this device, built when not given."""
    dev = current_hist.device
    w = weights if weights is not None else config.weights(dev)
    health = health_score(telemetry, w.alpha)
    drift = drift_mod.drift_score(current_hist, state.prev_hist)

    # Ablation knobs (§IV.E): disabled gates become always-pass.
    eff_health = health if config.health_gating else torch.ones_like(health)
    eff_drift = drift if config.drift_gating else torch.zeros_like(drift)
    theta_e = (
        state.theta_e
        if config.adaptive_energy
        else torch.full_like(state.theta_e, config.theta_e)
    )
    thresholds = Thresholds(
        health=scalar(config.theta_h, dev),
        energy=theta_e,
        drift=scalar(config.theta_d, dev),
    )
    selection = select_clients(
        eff_health, telemetry.energy, eff_drift, thresholds, w.beta, config.top_k
    )
    # Report true health/drift in the result even when gating is ablated.
    selection = dataclasses.replace(selection, health=health, drift=drift)

    delays = cs.invocation_delay(state.warm, config.cold_start)
    n_cold = cs.count_cold_starts(selection.mask, state.warm)
    new_warm, new_last_used = cs.update_container_cache(
        state.warm, state.last_used, selection.mask, state.round_index,
        config.cold_start,
    )
    new_state = SchedulerState(
        prev_hist=drift_mod.normalize_histogram(current_hist),
        theta_e=state.theta_e,  # decayed in account_energy (needs E_i obs)
        warm=new_warm,
        last_used=new_last_used,
        energy_spent=state.energy_spent,
        round_index=state.round_index + 1,
    )
    return RoundDecision(
        selection=selection, delays_ms=delays, cold_starts=n_cold,
        new_state=new_state,
    )


def account_energy(
    state: SchedulerState, round_energy_j: Array, config: SchedulerConfig
) -> SchedulerState:
    """Post-round energy bookkeeping: Eq. 10 threshold decay + cumulative spend."""
    theta_e = state.theta_e
    if config.adaptive_energy:
        theta_e = energy_mod.decay_energy_threshold(
            theta_e, round_energy_j, config.energy_model
        )
    return dataclasses.replace(
        state, theta_e=theta_e, energy_spent=state.energy_spent + round_energy_j
    )
