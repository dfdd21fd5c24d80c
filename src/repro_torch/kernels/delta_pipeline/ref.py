"""Plain PyTorch versions of K2, K3 and K4 (port of
``repro/kernels/delta_pipeline/ref.py``; K4's plain version is new here,
the JAX package tests its kernel against the sharded reference).

``delta_pipeline_ref`` composes the per-stage reference semantics on the
fused (C, P) buffer in the round's order: clip (per client) →
compression emulation (per leaf, on static segment slices) →
staleness-discounted Eq. 6 aggregation or masked median / trimmed mean
(``core.aggregation``) → DP noise → server momentum → apply.

The Eq. 6 sum runs over clients in order with one fused multiply-add per
client, and the plain apply is one fused multiply-add — the arithmetic
of XLA's CPU dot and loop fusion that the JAX reference compiles to — so
this version equals the JAX reference bitwise with every gate off. torch
has no float32 FMA on tensors; ``_fma`` takes the exact product in
float64 and rounds the sum once to float32.
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregation import median_aggregate, trimmed_mean_aggregate
from repro_torch.kernels.delta_pipeline.delta_pipeline import validate

_EPS = 1e-12


def _fma(a, b, c) -> torch.Tensor:
    """float32 a·b + c with one rounding (the float64 product of two
    float32 values is exact)."""
    return (
        torch.as_tensor(a).double() * torch.as_tensor(b).double()
        + torch.as_tensor(c).double()
    ).float()


def delta_sq_norms_ref(updates: torch.Tensor) -> torch.Tensor:
    """Per-client Σx² over the (C, P) buffer -> (C,) f32."""
    return torch.sum(torch.square(updates.to(torch.float32)), dim=1)


def _clip_scales(updates, clip_norm):
    norm = torch.sqrt(delta_sq_norms_ref(updates))
    limit = torch.tensor(clip_norm, dtype=torch.float32, device=updates.device)
    return torch.clamp(limit / torch.clamp(norm, min=1e-12), max=1.0)


def _compress(updates, compression, topk_fraction, seg_sizes):
    """Per-leaf compression semantics replayed on static segment slices."""
    parts, off = [], 0
    for sz in seg_sizes:
        x = updates[:, off:off + sz]
        off += sz
        if compression == "int8":
            scale = torch.amax(torch.abs(x), dim=1, keepdim=True) / 127.0 + 1e-12
            q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
            parts.append(q.to(torch.float32) * scale)
        else:  # topk
            k = max(1, int(sz * topk_fraction))
            thresh = torch.topk(torch.abs(x), k, dim=1).values[:, -1:]
            parts.append(x * (torch.abs(x) >= thresh))
    return torch.cat(parts, dim=1)


def _transform(x, clip_norm, compression, topk_fraction, seg_sizes):
    """Clip (per client), then compression emulation (per leaf)."""
    if clip_norm and clip_norm > 0:
        x = x * _clip_scales(x, clip_norm)[:, None]
    if compression != "none":
        x = _compress(x, compression, topk_fraction, seg_sizes)
    return x


def _weighted_sum(w, x):
    """Σ_c w_c·x_c over clients in order, one float32 FMA each (the
    kernels' order and XLA's CPU dot)."""
    agg = torch.zeros_like(x[0])
    for c in range(x.shape[0]):
        agg = _fma(w[c], x[c], agg)
    return agg


def delta_pipeline_partial_ref(
    updates,  # (C_local, P)
    dm,  # (C_local,) UNnormalized weights
    *,
    clip_norm: float = 0.0,
    compression: str = "none",
    topk_fraction: float = 0.05,
    seg_sizes=None,
    out=None,
):
    """K4's function: clip + compression on this block's clients, then the
    UNnormalized weighted sum Σ dm_i·x_i -> (P,) f32 (written into
    ``out`` when given)."""
    validate(updates, compression, seg_sizes, "fedavg", None)
    x = _transform(updates.to(torch.float32), clip_norm, compression,
                   topk_fraction, seg_sizes)
    agg = _weighted_sum(dm.to(torch.float32), x)
    return agg if out is None else out.copy_(agg)


def delta_pipeline_ref(
    updates,  # (C, P)
    base,  # (P,)
    mask,  # (C,) bool
    weights,  # (C,)
    lr=1.0,
    staleness=None,  # (C,) or None
    staleness_exponent=0.0,
    dp_noise=None,  # (P,) pre-scaled noise or None
    momentum=None,  # (P,) server momentum or None
    trim_fraction=0.1,
    *,
    clip_norm: float = 0.0,
    compression: str = "none",
    topk_fraction: float = 0.05,
    seg_sizes=None,
    server_optimizer: str = "fedavg",
    server_momentum: float = 0.9,
    aggregator: str = "fedavg",
):
    validate(updates, compression, seg_sizes, aggregator, staleness)
    x = _transform(updates.to(torch.float32), clip_norm, compression,
                   topk_fraction, seg_sizes)

    if aggregator == "median":
        agg = median_aggregate(x, mask)
    elif aggregator == "trimmed":
        agg = trimmed_mean_aggregate(x, mask, trim_fraction)
    else:
        m = mask.to(torch.float32) * weights.to(torch.float32)
        damping = None
        if staleness is not None:
            s = torch.clamp(staleness.to(torch.float32), min=0.0)
            disc = (1.0 + s) ** (
                -torch.as_tensor(staleness_exponent, dtype=torch.float32)
            )
            dm = m * disc
            w = dm / (torch.sum(dm) + _EPS)
            damping = (torch.sum(dm) + _EPS) / (torch.sum(m) + _EPS)
        else:
            w = m / (torch.sum(m) + _EPS)
        agg = _weighted_sum(w, x)
        if damping is not None:
            agg = agg * damping
    if dp_noise is not None:
        agg = agg + dp_noise.to(torch.float32)

    lr32 = torch.tensor(float(lr), dtype=torch.float32, device=agg.device)
    if momentum is not None and server_optimizer in ("fedavgm", "fedadam"):
        mu2 = server_momentum * momentum.to(torch.float32) + agg
        step = lr32 * mu2
        if server_optimizer == "fedadam":
            step = step / (torch.sqrt(torch.square(agg)) + 1e-3)
        out = (base.to(torch.float32) + step).to(base.dtype)
        return out, mu2.to(momentum.dtype)
    return _fma(lr32, agg, base.to(torch.float32)).to(base.dtype)
