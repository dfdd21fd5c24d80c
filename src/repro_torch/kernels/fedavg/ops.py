"""Public entry points of K1 (port of ``repro/kernels/fedavg/ops.py`` and
``fedavg.py``'s ``fedavg_apply`` / ``fedavg_apply_tree``).

A CPU tensor goes to the plain version (``ref.py``), a CUDA tensor to
the hand-written kernel (``fedavg.py``); anything else raises. No path of
the port's simulator reaches K1 (nor does any of the JAX package's): the
rounds aggregate through K3 and K4.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.kernels.fedavg.fedavg import fedavg_apply_cuda
from repro_torch.kernels.fedavg.ref import fedavg_apply_ref


def fedavg_apply(updates: torch.Tensor, base: torch.Tensor, mask: torch.Tensor,
                 weights: torch.Tensor, lr=1.0) -> torch.Tensor:
    """``base + lr·Σ_i m_i·ω_i·Δ_i / Σ_j m_j·ω_j`` over (N, D) updates."""
    if updates.device.type == "cpu":
        return fedavg_apply_ref(updates, base, mask, weights, lr=lr)
    if updates.device.type == "cuda":
        return fedavg_apply_cuda(updates, base, mask, weights, lr=lr)
    raise ValueError(f"no fedavg kernel for device {updates.device}")


def fedavg_apply_tree(updates_tree, base_tree, mask, weights, lr=1.0):
    """Apply leaf-wise over parameter trees: ``updates_tree`` leaves are
    (N, ...) stacked client deltas, ``base_tree`` leaves (...)."""
    def one(upd, base):
        out = fedavg_apply(upd.reshape(upd.shape[0], -1), base.reshape(-1), mask,
                           weights, lr=lr)
        return out.reshape(base.shape)

    return tree.map(one, updates_tree, base_tree)
