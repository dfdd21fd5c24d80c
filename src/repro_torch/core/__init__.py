"""FedFog core: the paper's contribution (Eqs. 1-12) on torch tensors."""
from repro_torch.core.aggregation import (
    fedavg_stacked,
    fedavg_weights,
    median_aggregate,
    trimmed_mean_aggregate,
)
from repro_torch.core.coldstart import (
    ColdStartConfig,
    count_cold_starts,
    invocation_delay,
    update_container_cache,
)
from repro_torch.core.drift import (
    drift_score,
    kl_divergence,
    normalize_histogram,
    token_histogram,
)
from repro_torch.core.energy import (
    EnergyModelConfig,
    battery_drain,
    decay_energy_threshold,
    round_energy,
)
from repro_torch.core.health import health_score
from repro_torch.core.privacy import (
    DPConfig,
    epsilon,
    gaussian_mechanism,
)
from repro_torch.core.scheduler import (
    RoundDecision,
    SchedulerConfig,
    account_energy,
    schedule_round,
)
from repro_torch.core.selection import (
    random_selection_mask,
    select_clients,
    threshold_mask,
    topk_mask,
)
from repro_torch.core.types import (
    ClientTelemetry,
    SchedulerState,
    SchedulerWeights,
    SelectionResult,
    Thresholds,
    init_scheduler_state,
)
from repro_torch.core.utility import utility_ranking, utility_score

__all__ = [
    "ClientTelemetry",
    "ColdStartConfig",
    "DPConfig",
    "EnergyModelConfig",
    "RoundDecision",
    "SchedulerConfig",
    "SchedulerState",
    "SchedulerWeights",
    "SelectionResult",
    "Thresholds",
    "account_energy",
    "battery_drain",
    "count_cold_starts",
    "decay_energy_threshold",
    "drift_score",
    "epsilon",
    "fedavg_stacked",
    "fedavg_weights",
    "gaussian_mechanism",
    "health_score",
    "init_scheduler_state",
    "invocation_delay",
    "kl_divergence",
    "median_aggregate",
    "normalize_histogram",
    "random_selection_mask",
    "round_energy",
    "schedule_round",
    "select_clients",
    "threshold_mask",
    "token_histogram",
    "topk_mask",
    "trimmed_mean_aggregate",
    "update_container_cache",
    "utility_ranking",
    "utility_score",
]
