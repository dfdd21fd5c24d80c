"""Data-drift detection — paper Eq. 2 (port of ``repro/core/drift.py``).

``D(c_i) = KL( P_t(D_i) || P_{t-1}(D_i) )`` on label histograms.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import Array

_EPS = 1e-8


def normalize_histogram(counts: Array, eps: float = _EPS) -> Array:
    """Counts -> probability distribution along the last axis (smoothed)."""
    counts = counts.to(torch.float32) + eps
    return counts / torch.sum(counts, dim=-1, keepdim=True)


def kl_divergence(p: Array, q: Array, eps: float = _EPS) -> Array:
    """``KL(p || q)`` along the last axis. Inputs are probability vectors."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    q = q / torch.sum(q, dim=-1, keepdim=True)
    ratio = torch.log(p + eps) - torch.log(q + eps)
    return torch.sum(p * ratio, dim=-1)


def drift_score(current_hist: Array, prev_hist: Array) -> Array:
    """Eq. 2: (N,) per-client KL between this and last round's distribution."""
    return kl_divergence(
        normalize_histogram(current_hist), normalize_histogram(prev_hist)
    )


def token_histogram(tokens: Array, vocab_bins: int, vocab_size: int) -> Array:
    """Bucketed token histogram for LM clients: (..., vocab_bins) counts."""
    bucket = (tokens.to(torch.int64) * vocab_bins // vocab_size).clamp(
        0, vocab_bins - 1
    )
    oh = (
        bucket[..., None]
        == torch.arange(vocab_bins, device=tokens.device)
    ).to(torch.float32)
    return torch.sum(oh, dim=-2)
