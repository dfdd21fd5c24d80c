"""Global-norm clipping (the part of ``repro/optim/optimizers.py`` the
simulator round uses)."""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.device import scalar


def global_norm(t, *, per_client: bool = False) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²); per client (leading axis) if asked."""
    if per_client:
        sq = sum(
            torch.sum(torch.square(l.to(torch.float32)).reshape(l.shape[0], -1), 1)
            for l in tree.leaves(t)
        )
    else:
        sq = sum(torch.sum(torch.square(l.to(torch.float32))) for l in tree.leaves(t))
    return torch.sqrt(sq)


def clip_by_global_norm(t, max_norm: float, *, per_client: bool = False):
    """Scale ``t`` so its global norm is at most ``max_norm``. With
    ``per_client=True`` every leaf has a leading client axis and each
    client is clipped on its own norm (the JAX round vmaps the unbatched
    function). Returns ``(clipped, norm)``."""
    norm = global_norm(t, per_client=per_client)
    scale = torch.clamp(scalar(max_norm, norm.device) / torch.clamp(norm, min=1e-12),
                        max=1.0)

    def one(l):
        s = scale.reshape((-1,) + (1,) * (l.dim() - 1)) if per_client else scale
        return (l * s).to(l.dtype)

    return tree.map(one, t), norm
