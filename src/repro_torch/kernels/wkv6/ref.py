"""Plain PyTorch version of K6: the sequential RWKV6 recurrence (port of
``repro/kernels/wkv6/ref.py``).

    y_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t)
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t

r/k/w: (B, T, H, K), v: (B, T, H, V); u: (H, K); state (B, H, K, V)
float32. Every product in float32; y rounded once to r's dtype.
``wkv6_step`` is one step of it, which the model's decode step runs.
"""
from __future__ import annotations

import torch


def wkv6_step(r_t, k_t, v_t, w_t, u, state):
    """One step. r/k/v/w: (B, H, K|V); state (B, H, K, V).
    Returns (y (B, H, V) in r_t's dtype, new float32 state)."""
    r32, k32, v32, w32 = (z.to(torch.float32) for z in (r_t, k_t, v_t, w_t))
    s = state.to(torch.float32)
    kv = k32[..., :, None] * v32[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r32,
                     s + u.to(torch.float32)[None, :, :, None] * kv)
    return y.to(r_t.dtype), w32[..., None] * s + kv


def wkv6_ref(r, k, v, w, u, initial_state=None):
    b, t, h, dk = r.shape
    s = (
        torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32, device=r.device)
        if initial_state is None
        else initial_state
    )
    ys = []
    for i in range(t):
        y_t, s = wkv6_step(r[:, i], k[:, i], v[:, i], w[:, i], u, s)
        ys.append(y_t)
    return torch.stack(ys, dim=1), s
