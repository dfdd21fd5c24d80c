"""Public entry point of K6 (port of ``repro/kernels/wkv6/ops.py``).

The JAX wrapper pads T to a multiple of its chunk with w = 1 (and zero
r, k, v, which leaves y[:T] and the state unchanged) and clamps
w >= e^-20 in w's dtype before its chunked kernel, whose closed form
divides by in-chunk decay products. Neither recurrence here works in
chunks, so only the clamp carries over: :func:`wkv6_plain` is the clamp
around the plain recurrence (``ref.py``), and a CPU tensor takes it. A
CUDA tensor goes to the hand-written kernel (``wkv6.py``), which applies
the same clamp as it reads w, so the model's views go in without a
clamped copy. Anything else raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.ref import wkv6_ref
from repro_torch.kernels.wkv6.wkv6 import wkv6_cuda


def w_floor(dtype: torch.dtype) -> float:
    """e^-20 rounded to ``dtype``: the wrapper's clamp on w."""
    return float(torch.exp(torch.tensor(-20.0)).to(dtype))


def wkv6_plain(r, k, v, w, u):
    """The JAX wrapper's clamp on w around the plain recurrence."""
    return wkv6_ref(r, k, v, w.clamp(min=w_floor(w.dtype)), u)


def wkv6(r, k, v, w, u):
    """r/k/w: (B, T, H, K), v: (B, T, H, V), u: (H, K) -> (y (B, T, H, V)
    in r's dtype, final state (B, H, K, V) float32), from a zero state."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u)
    if r.device.type == "cuda":
        return wkv6_cuda(r, k, v, w, u, w_min=w_floor(w.dtype))
    raise ValueError(f"no wkv6 kernel for device {r.device}")
