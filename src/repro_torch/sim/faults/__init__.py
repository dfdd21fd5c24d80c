"""Fault-injection and recovery layer of the sync round (port of
``repro/sim/faults``): the fault plan in ``config.py``, its realization
in ``inject.py``."""
from repro_torch.sim.faults.config import (
    RATE_FIELDS,
    SCALE_FIELDS,
    FaultConfig,
    active,
    backoff_ms,
    validate,
)
from repro_torch.sim.faults.inject import (
    COUNTER_KEYS,
    RoundFaultPlan,
    plan_round,
    zero_counters,
)

__all__ = [
    "FaultConfig",
    "RATE_FIELDS",
    "SCALE_FIELDS",
    "active",
    "backoff_ms",
    "validate",
    "COUNTER_KEYS",
    "RoundFaultPlan",
    "plan_round",
    "zero_counters",
]
