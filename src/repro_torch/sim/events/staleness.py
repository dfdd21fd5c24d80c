"""Staleness-discounted aggregation, the async generalization of Eq. 6
(port of ``repro/sim/events/staleness.py``).

Updates that arrive asynchronously were computed against an older model
version; the server discounts each by a polynomial factor of its
model-version staleness s (FedAsync, Xie et al.; FedBuff, Nguyen et al.):

    disc(s) = (1 + s)^(-a)                        a = staleness_exponent ≥ 0
    agg     = Σ_{i∈B} ŵ_i·Δ_i,   ŵ_i ∝ m_i·|D_i|·disc(s_i)
    scale   = (Σ m_i·|D_i|·disc(s_i) + ε) / (Σ m_i·|D_i| + ε)
    w      ← w + η_server · scale · agg

With zero staleness (or a = 0) the rule is ``core.aggregation.
fedavg_stacked`` exactly: scale is the constant 1.0 and ŵ the Eq. 6
weights. Scalars are fills on the tensors' device (``device.scalar``),
never host copies.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core.aggregation import _EPS, fedavg_stacked
from repro_torch.device import scalar

Array = torch.Tensor


def stale_discount(staleness: Array, exponent: float) -> Array:
    """Polynomial staleness discount ``(1 + s)^(-a)``; s clipped at 0."""
    s = torch.clamp(staleness.to(torch.float32), min=0.0)
    return (1.0 + s) ** (-scalar(exponent, s.device))


def staleness_weights(mask: Array, data_sizes: Array, staleness: Array,
                      exponent: float) -> tuple[Array, Array]:
    """(normalized weights ŵ (N,), global damping scale ()): ŵ sums to ~1
    over the buffer; scale is exactly 1.0 when no buffered update is
    stale."""
    disc = stale_discount(staleness, exponent)
    sized = mask.to(torch.float32) * data_sizes.to(torch.float32)
    discounted = sized * disc
    w = discounted / (torch.sum(discounted) + _EPS)
    scale = (torch.sum(discounted) + _EPS) / (torch.sum(sized) + _EPS)
    return w, scale


def async_aggregate(updates, mask: Array, data_sizes: Array, staleness: Array,
                    exponent: float):
    """Staleness-discounted Eq. 6 over a tree of (N, ...)-stacked updates,
    through ``fedavg_stacked`` on discounted sizes so that zero staleness
    is bit-identical to the synchronous aggregation."""
    disc = stale_discount(staleness, exponent)
    agg = fedavg_stacked(updates, mask, data_sizes * disc)
    sized = mask.to(torch.float32) * data_sizes.to(torch.float32)
    scale = (torch.sum(sized * disc) + _EPS) / (torch.sum(sized) + _EPS)
    return tree.map(lambda a: a * scale.to(a.dtype), agg)
