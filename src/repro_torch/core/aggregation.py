"""Aggregation — paper Eq. 6 (weighted FedAvg) + robust variants (port of
``repro/core/aggregation.py``; ``fedavg_stacked``, ``median_aggregate``
and ``trimmed_mean_aggregate``). Updates are trees whose leaves carry a
leading client axis."""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core.types import Array

_EPS = 1e-12


def _bcast(v: Array, leaf: Array) -> Array:
    return v.reshape((-1,) + (1,) * (leaf.dim() - 1))


def fedavg_weights(mask: Array, data_sizes: Array) -> Array:
    """Normalized FedAvg weights ``m_i·|D_i| / Σ m_j·|D_j|``. Shape (N,)."""
    w = mask.to(torch.float32) * data_sizes.to(torch.float32)
    return w / (torch.sum(w) + _EPS)


def fedavg_stacked(updates, mask: Array, data_sizes: Array):
    """Eq. 6 over a tree whose leaves have a leading client axis."""
    w = fedavg_weights(mask, data_sizes)
    return tree.map(
        lambda leaf: torch.sum(_bcast(w, leaf).to(leaf.dtype) * leaf, dim=0),
        updates,
    )


def median_aggregate(updates, mask: Array):
    """Coordinate-wise median over selected clients: unselected entries
    sort to the top as +inf and the median is taken over the first
    ``num_sel`` rows (index arithmetic as in the JAX package, so
    ``num_sel == 0`` gives +inf)."""
    num_sel = torch.sum(mask.to(torch.int32))
    lo_idx = torch.clamp(torch.div(num_sel - 1, 2, rounding_mode="floor"), min=0)
    hi_idx = torch.div(num_sel, 2, rounding_mode="floor")

    def agg(leaf):
        hi = torch.where(_bcast(mask, leaf), leaf, torch.full_like(leaf, float("inf")))
        s = torch.sort(hi, dim=0).values
        shape = (1,) + tuple(leaf.shape[1:])
        lo = torch.gather(s, 0, lo_idx.to(torch.int64).expand(shape))
        hv = torch.gather(s, 0, hi_idx.to(torch.int64).expand(shape))
        return (0.5 * (lo + hv)).squeeze(0)

    return tree.map(agg, updates)


def trimmed_mean_aggregate(updates, mask: Array, trim_fraction: float = 0.1):
    """Coordinate-wise trimmed mean over selected clients."""
    num_sel = torch.sum(mask.to(torch.int32))
    k_trim = torch.floor(num_sel.to(torch.float32) * trim_fraction).to(torch.int32)

    def agg(leaf):
        n = leaf.shape[0]
        hi = torch.where(
            _bcast(mask, leaf), leaf.to(torch.float32),
            torch.full(leaf.shape, float("inf"), device=leaf.device),
        )
        s = torch.sort(hi, dim=0).values
        idx = _bcast(torch.arange(n, device=leaf.device), leaf)
        keep = (idx >= k_trim) & (idx < num_sel - k_trim)
        total = torch.sum(torch.where(keep, s, torch.zeros_like(s)), dim=0)
        cnt = torch.clamp(num_sel - 2 * k_trim, min=1).to(torch.float32)
        return (total / cnt).to(leaf.dtype)

    return tree.map(agg, updates)
