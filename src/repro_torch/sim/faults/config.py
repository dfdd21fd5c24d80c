"""Declarative fault plan of the simulator (port of
``repro/sim/faults/config.py``).

``FaultConfig`` describes serverless failure modes (cold-start timeout,
mid-update crash, dropped or corrupted payload, transient partitions,
fog outages) and the recovery policies that answer them (per-client
retry with exponential backoff, a server round deadline with
quorum-degraded aggregation, fog failover).

The composite gate (``active``), the retry cap, the deadline's
None-ness and the failover flag choose Python branches; rates and scales
are numbers on the round path. With the gate off the round takes its
fault-free code path unchanged. Failure draws use ``uniform < rate``, so
a rate of exactly 0.0 never fires (a uniform draw is never < 0).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import static_any


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault-injection and recovery knobs. All rates are per-invocation
    (or per-fog / per-round where noted) probabilities in [0, 1].

    Failure classes
    ---------------
    timeout_rate:    cold-start timeout: only a COLD invocation (Eq. 4
                     warm=False) can time out, and only on attempt 0.
    crash_rate:      function crash mid-update; every attempt is exposed.
    drop_rate:       payload lost in transit; every attempt is exposed.
    corrupt_rate:    payload arrives bit-rotted: the update lands with
                     additive noise of scale ``corrupt_scale`` (the
                     attacks' noise, accounted as a fault).
    partition_rate:  per-round probability of a transient network
                     partition cutting off a random ``partition_frac``
                     of the cohort (their attempt 0 fails).
    fog_outage_rate: per-round probability that each fog node goes
                     dark. Without failover its clients' updates are
                     lost (``fault_lost``); with ``fog_failover`` they
                     reroute to surviving fogs at ``failover_latency_ms``.

    Recovery policies
    -----------------
    max_retries:     per-client retry cap (an int that sets the number of
                     attempts). 0 = a failed invocation is terminal.
    backoff_base_ms / backoff_mult: the wait before retry attempt a
                     (1-based) is ``base * mult**(a-1)``.
    deadline_ms:     server round deadline (None = wait for everyone).
                     Updates arriving after it are lost.
    quorum_frac:     minimum arrived/admitted fraction for the round to
                     aggregate. Below it the round is SKIPPED and the
                     model carries over bitwise; at or above it the
                     arrivals aggregate with Eq. 6 reweighting.
    """

    timeout_rate: float = 0.0
    crash_rate: float = 0.0
    drop_rate: float = 0.0
    corrupt_rate: float = 0.0
    corrupt_scale: float = 0.05
    partition_rate: float = 0.0
    partition_frac: float = 0.25
    fog_outage_rate: float = 0.0
    fog_failover: bool = False
    failover_latency_ms: float = 250.0
    max_retries: int = 0
    backoff_base_ms: float = 100.0
    backoff_mult: float = 2.0
    deadline_ms: float | None = None
    quorum_frac: float = 0.0


# Rate fields whose positivity makes up the composite gate.
RATE_FIELDS = (
    "timeout_rate", "crash_rate", "drop_rate", "corrupt_rate",
    "partition_rate", "fog_outage_rate",
)
# Numeric knobs that do not gate.
SCALE_FIELDS = (
    "corrupt_scale", "partition_frac", "failover_latency_ms",
    "backoff_base_ms", "backoff_mult", "quorum_frac",
)


def active(fc: FaultConfig | None) -> bool:
    """The ONE gate of the fault layer: True iff any failure class can
    fire or a deadline is set."""
    if fc is None:
        return False
    if fc.deadline_ms is not None:
        return True
    return static_any(*(getattr(fc, f) for f in RATE_FIELDS))


def validate(fc: FaultConfig) -> None:
    """Host-side sanity check of the configuration."""
    for f in RATE_FIELDS + ("partition_frac", "quorum_frac"):
        v = getattr(fc, f)
        if not 0.0 <= float(v) <= 1.0:
            raise ValueError(f"FaultConfig.{f} must be in [0, 1], got {v}")
    if int(fc.max_retries) < 0:
        raise ValueError("FaultConfig.max_retries must be >= 0")
    if fc.deadline_ms is not None and float(fc.deadline_ms) <= 0:
        raise ValueError("FaultConfig.deadline_ms must be positive")
    if not float(fc.backoff_mult) > 0:
        raise ValueError("FaultConfig.backoff_mult must be > 0")


def backoff_ms(fc: FaultConfig, attempt: int) -> float:
    """Backoff delay in ms before (1-based) retry ``attempt``,
    ``base * mult**(attempt-1)``, computed in float32 as the JAX package
    computes it, and returned as a host float."""
    step = np.float32(fc.backoff_mult) ** np.float32(attempt - 1)
    return float(np.float32(fc.backoff_base_ms) * step)
