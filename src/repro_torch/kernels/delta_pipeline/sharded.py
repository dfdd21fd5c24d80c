"""The cloud-side epilogue of a hierarchical combine (port of
``combine_epilogue`` in ``repro/kernels/delta_pipeline/sharded.py``).

Plain tensor math on the (P,) sum of the fogs' partials, not a kernel:
normalize → DP noise → server momentum / Adam → apply, the formulas of
``delta_pipeline_apply`` term for term. The rest of the JAX module (the
``shard_map`` path across devices) is not ported yet (ROADMAP queue 1,
item 11).
"""
from __future__ import annotations

import torch

_EPS = 1e-12  # matches core.aggregation._EPS


def combine_epilogue(
    agg_sum: torch.Tensor,  # (P,) combined UNnormalized weighted delta sum
    sdm: torch.Tensor,  # () Σ mask·|D|·staleness-discount
    sm: torch.Tensor,  # () Σ mask·|D|
    base: torch.Tensor,  # (P,) fused global model
    lr,
    *,
    has_stale: bool,
    dp_noise: torch.Tensor | None = None,
    momentum: torch.Tensor | None = None,
    server_optimizer: str = "fedavg",
    server_momentum: float = 0.9,
):
    """Returns ``(new_base, new_momentum or None)``."""
    if has_stale:
        # normalize by Σdm, then the async_aggregate global damping
        agg = agg_sum / (sdm + _EPS)
        agg = agg * ((sdm + _EPS) / (sm + _EPS))
    else:
        agg = agg_sum / (sm + _EPS)
    if dp_noise is not None:
        agg = agg + dp_noise.to(torch.float32)
    if momentum is not None:
        mu2 = server_momentum * momentum.to(torch.float32) + agg
        step = lr * mu2
        if server_optimizer == "fedadam":
            step = step / (torch.sqrt(torch.square(agg)) + 1e-3)
        out = (base.to(torch.float32) + step).to(base.dtype)
        return out, mu2.to(momentum.dtype)
    return (base.to(torch.float32) + lr * agg).to(base.dtype), None
