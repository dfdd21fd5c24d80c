"""Fault counters of the sync round (port of the counter part of
``repro/sim/faults/inject.py``). The round's metrics carry every counter
channel as a zero when faults are off, so histories keep one schema;
fault planning itself is not ported yet (ROADMAP queue 1, 'faults')."""
from __future__ import annotations

import torch

COUNTER_KEYS = (
    "fault_dispatched", "fault_completed", "fault_terminal", "fault_lost",
    "fault_retries", "fault_corrupt", "fog_outages", "fault_failed_over",
    "round_skipped",
)


def zero_counters(device) -> dict[str, torch.Tensor]:
    return {
        k: torch.zeros((), dtype=torch.int32, device=device) for k in COUNTER_KEYS
    }
