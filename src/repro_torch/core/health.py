"""Health scoring — paper Eq. 1 (port of ``repro/core/health.py``).

``H(c_i) = a1 * CPU_i + a2 * MEM_i + a3 * BATT_i`` with ``a1+a2+a3 = 1``.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import Array, ClientTelemetry


def health_score(telemetry: ClientTelemetry, alpha: Array) -> Array:
    """Eq. 1: (N,) float32 convex combination of CPU / MEM / BATT."""
    stacked = torch.stack([telemetry.cpu, telemetry.mem, telemetry.batt], dim=-1)
    return (stacked @ alpha.to(stacked.dtype)).to(torch.float32)
