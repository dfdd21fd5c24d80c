"""Plain PyTorch version of K5, the flash-attention forward (port of
``repro/kernels/flash_attention/ref.py``).

Layout of the kernel (heads-major): q (B, H, Sq, hd), k/v (B, Hkv, Sk, hd).
Mask: causal with an optional sliding window (``window <= 0`` means
global), q rows at the LAST Sq positions of the Sk keys; or none when
``bidirectional``. Scores and softmax in float32; output in q's dtype.
"""
from __future__ import annotations

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = 0, bidirectional: bool = False) -> torch.Tensor:
    b, h, sq, hd = q.shape
    _, hkv, sk, _ = k.shape
    groups = h // hkv
    k = torch.repeat_interleave(k, groups, dim=1)
    v = torch.repeat_interleave(v, groups, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * hd**-0.5
    if not bidirectional:
        q_pos = torch.arange(sq, device=q.device) + (sk - sq)
        k_pos = torch.arange(sk, device=q.device)
        visible = k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            visible &= (q_pos[:, None] - k_pos[None, :]) < window
        scores = scores.masked_fill(~visible[None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)
