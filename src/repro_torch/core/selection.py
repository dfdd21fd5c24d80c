"""Client selection — paper Eq. 3 + top-K utility gating (port of
``repro/core/selection.py``). Outputs are static-shape (N,) masks."""
from __future__ import annotations

import torch

from repro_torch.core.types import Array, SelectionResult, Thresholds
from repro_torch.core.utility import utility_ranking, utility_score


def threshold_mask(
    health: Array, energy: Array, drift: Array, thresholds: Thresholds
) -> Array:
    """Eq. 3: strict-threshold eligibility gate. Returns (N,) bool."""
    return (
        (health > thresholds.health)
        & (energy > thresholds.energy)
        & (drift < thresholds.drift)
    )


def _rank(order: Array) -> Array:
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device).to(order.dtype)
    return rank


def topk_mask(utility: Array, eligible: Array, k: int | None) -> Array:
    """Keep at most ``k`` eligible clients, preferring higher utility.

    A rank-compare after a STABLE argsort of ``-utility`` (ties go to the
    lower client index, as in the JAX package); ``torch.topk`` promises no
    tie order and is not used.
    """
    if k is None or k >= utility.shape[0]:
        return eligible
    masked_u = torch.where(
        eligible, utility, torch.full_like(utility, -float("inf"))
    )
    order = torch.argsort(-masked_u, stable=True)
    return eligible & (_rank(order) < k)


def select_clients(
    health: Array,
    energy: Array,
    drift: Array,
    thresholds: Thresholds,
    beta: Array,
    k: int | None = None,
) -> SelectionResult:
    """Full FedFog selection: Eq. 3 gate, Eq. 7 utility, top-K budget."""
    eligible = threshold_mask(health, energy, drift, thresholds)
    utility = utility_score(health, energy, drift, beta)
    mask = topk_mask(utility, eligible, k)
    return SelectionResult(
        mask=mask,
        utility=utility,
        health=health,
        drift=drift,
        order=utility_ranking(utility),
        num_selected=torch.sum(mask.to(torch.int32)),
    )


def random_selection_mask(perm: Array, k: int) -> Array:
    """The RCS baseline (§IV.B): k clients uniformly at random.

    ``perm`` is the (N,) permutation drawn at the ``rcs.perm`` site (the
    JAX function takes the key and draws it itself)."""
    return _rank(perm.to(torch.int64)) < k
