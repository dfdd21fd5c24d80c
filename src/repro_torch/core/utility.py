"""Scheduler utility — paper Eq. 7 (port of ``repro/core/utility.py``).

``U(c_i) = b1 * H(c_i) + b2 * E(c_i) - b3 * D(c_i)``  with  ``b1+b2+b3 = 1``.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import Array


def utility_score(health: Array, energy: Array, drift: Array, beta: Array) -> Array:
    """Eq. 7 — (N,) float32 utility scores."""
    beta = beta.to(torch.float32)
    return (
        beta[0] * health.to(torch.float32)
        + beta[1] * energy.to(torch.float32)
        - beta[2] * drift.to(torch.float32)
    )


def utility_ranking(utility: Array) -> Array:
    """Descending-utility client order (the paper's priority queue), ties
    broken by client index (stable sort). (N,) int32."""
    return torch.argsort(-utility, stable=True).to(torch.int32)
