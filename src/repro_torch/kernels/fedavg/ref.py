"""Plain PyTorch version of K1, the fused FedAvg apply (port of
``repro/kernels/fedavg/ref.py``).

    out = base + lr · Σ_i  m_i·ω_i·Δ_i / Σ_j m_j·ω_j

updates: (N, D) client deltas; base: (D,); mask: (N,) bool; weights: (N,)
(|D_i| dataset sizes). Sums in float32; the output in base's dtype.
"""
from __future__ import annotations

import torch


def fedavg_apply_ref(updates, base, mask, weights, lr: float = 1.0):
    w = mask.to(torch.float32) * weights.to(torch.float32)
    w = w / (torch.sum(w) + 1e-12)
    agg = torch.einsum("n,nd->d", w, updates.to(torch.float32))
    return (base.to(torch.float32) + lr * agg).to(base.dtype)
