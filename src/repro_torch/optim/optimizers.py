"""Minimal tree optimizers (port of ``repro/optim/optimizers.py``).

Both optimizers follow the (init_fn, update_fn) convention:

    init_fn(params)                    -> state
    update_fn(grads, state, params)    -> (updates, state)
    apply_updates(params, updates)     -> params

States hold float32 moments and a () int32 step count on the parameters'
device; the parameters keep their dtype (bf16 parameters with float32
moments, the mixed-precision setup). ``learning_rate`` is a float or a
schedule (``optim.schedules``), a callable of the count tensor. Nothing
here reads a value back from the device: a Python constant enters a
kernel as an argument or, where it must be a tensor, as a fill
(``device.scalar``).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree
from repro_torch.device import scalar


class OptState(NamedTuple):
    count: torch.Tensor  # () int32
    mu: Any  # first moment (or momentum)
    nu: Any  # second moment (None for sgdm)


def _f32_like(t):
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), t)


def _count0(params) -> torch.Tensor:
    dev = tree.leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


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


def apply_updates(params, updates):
    """``p + u`` in float32, cast back to each parameter's dtype."""
    return tree.map(
        lambda p, u: (p.to(torch.float32) + u.to(torch.float32)).to(p.dtype),
        params, updates,
    )


def _lr_at(learning_rate, count):
    return learning_rate(count) if callable(learning_rate) else learning_rate


def adamw(
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
):
    """Adam with bias correction and decoupled weight decay."""

    def init_fn(params):
        return OptState(_count0(params), _f32_like(params), _f32_like(params))

    def update_fn(grads, state: OptState, params):
        count = state.count + 1
        cf = count.to(torch.float32)
        mu = tree.map(
            lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32), state.mu, grads
        )
        nu = tree.map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
            state.nu, grads,
        )
        mu_hat_scale = 1.0 / (1 - b1**cf)
        nu_hat_scale = 1.0 / (1 - b2**cf)
        lr = _lr_at(learning_rate, count)

        def upd(m, v, p):
            step = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + eps)
            if weight_decay:
                step = step + weight_decay * p.to(torch.float32)
            return -lr * step

        return tree.map(upd, mu, nu, params), OptState(count, mu, nu)

    return init_fn, update_fn


def sgdm(
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor],
    momentum: float = 0.9,
    nesterov: bool = True,
):
    """SGD with (Nesterov) momentum."""

    def init_fn(params):
        return OptState(_count0(params), _f32_like(params), None)

    def update_fn(grads, state: OptState, params):
        del params
        count = state.count + 1
        mu = tree.map(
            lambda m, g: momentum * m + g.to(torch.float32), state.mu, grads
        )
        lr = _lr_at(learning_rate, count)
        if nesterov:
            updates = tree.map(
                lambda m, g: -lr * (momentum * m + g.to(torch.float32)), mu, grads
            )
        else:
            updates = tree.map(lambda m: -lr * m, mu)
        return updates, OptState(count, mu, None)

    return init_fn, update_fn
