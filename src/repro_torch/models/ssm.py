"""State-space recurrences in plain PyTorch (port of the RWKV6 part of
``repro/models/ssm.py``): ``wkv6`` over a sequence from an optional
initial state, and ``wkv6_step`` for one decode token, both K6's plain
version (``kernels/wkv6/ref.py``).

The JAX package scans ``wkv6`` in checkpointed chunks (``chunk`` bounds
what autodiff saves); the port runs no backward through it, so ``wkv6``
takes no chunk and runs step by step. The hand-written kernel of the
same recurrence from a zero state is K6; ``models/rwkv6`` sends its
prefill there.
``selective_scan`` (the HYBRID family) is not ported yet: ROADMAP.md
queue 1, item 10(b).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.ref import wkv6_ref, wkv6_step

Array = torch.Tensor

__all__ = ["wkv6", "wkv6_step"]


def wkv6(r: Array, k: Array, v: Array, w: Array, u: Array,
         initial_state: Array | None = None):
    """Returns (y (B, T, H, V), final_state (B, H, K, V) float32).

        y_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t)
        S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t

    The step-by-step recurrence of K6's plain version, from
    ``initial_state`` (zero if None)."""
    return wkv6_ref(r, k, v, w, u, initial_state)
