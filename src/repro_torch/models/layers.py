"""Shared model building blocks (port of ``repro/models/layers.py``):
norms, RoPE, masking and attention, on torch tensors in the JAX package's
layouts ((B, S, H, hd) activations).

Attention implementations, chosen by ``ModelConfig.attn_impl`` through
:func:`select_attention`:

  * ``"xla"`` / ``"auto"`` — materialised-score attention in plain torch
    (the JAX package leaves these to XLA; the port to PyTorch's ops);
  * ``"flash"`` — K5, the hand-written flash-attention kernel
    (``kernels/flash_attention``), or its plain version on the CPU;
  * ``"xla_chunked"`` — not ported yet (raises).

All share the mask convention: causal + optional sliding window, where
``window == GLOBAL (-1)`` means unbounded.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import GLOBAL

Array = torch.Tensor
_NEG_INF = -1e30


# --------------------------------------------------------------------- #
# Norms & MLPs
# --------------------------------------------------------------------- #
def rms_norm(x: Array, scale: Array, eps: float = 1e-6) -> Array:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def gated_mlp(x: Array, w_gate: Array, w_up: Array, w_down: Array, act: str) -> Array:
    """SwiGLU / GeGLU feed-forward."""
    gate = x @ w_gate
    up = x @ w_up
    if act == "silu":
        h = torch.nn.functional.silu(gate) * up
    elif act == "gelu":
        h = torch.nn.functional.gelu(gate, approximate="tanh") * up
    else:
        raise ValueError(f"unknown act {act}")
    return h @ w_down


# --------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, device=None) -> Array:
    """(head_dim//2,) float32 inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # theta as a fill, not a copy from the host (which would wait for the
    # device queue in every layer of a training step)
    return 1.0 / (torch.full((), theta, dtype=torch.float32, device=device) ** exponents)


def apply_rope(x: Array, positions: Array, theta: float) -> Array:
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S) or (S,)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * inv_freq  # (..., S, hd/2)
    angles = angles[..., None, :]  # broadcast over heads: (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# Masking
# --------------------------------------------------------------------- #
def causal_window_bias(q_positions: Array, k_positions: Array, window: int) -> Array:
    """Additive (..., Sq, Sk) float32 bias of {0, -1e30}: causal, and a
    sliding window unless ``window == GLOBAL``."""
    dq = q_positions[..., :, None]
    dk = k_positions[..., None, :]
    visible = dk <= dq
    if int(window) != GLOBAL:
        visible = visible & ((dq - dk) < max(int(window), 1))
    zero = torch.zeros((), dtype=torch.float32, device=dq.device)
    return torch.where(visible, zero, torch.full_like(zero, _NEG_INF))


def _repeat_kv(k: Array, groups: int) -> Array:
    """(B, S, Hkv, hd) -> (B, S, Hkv*groups, hd) for GQA."""
    if groups == 1:
        return k
    b, s, hkv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, hkv, groups, hd).reshape(b, s, hkv * groups, hd)


# --------------------------------------------------------------------- #
# Attention implementations
# --------------------------------------------------------------------- #
def attention_xla(
    q: Array, k: Array, v: Array, q_positions: Array, k_positions: Array,
    window: int, *, bidirectional: bool = False,
) -> Array:
    """Materialised-score attention. q: (B,Sq,H,hd), k/v: (B,Sk,Hkv,hd);
    positions 1-D (Sq,)/(Sk,), shared across the batch."""
    groups = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if not bidirectional:
        scores = scores + causal_window_bias(q_positions, k_positions, window)[None, None]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_decode(
    q: Array, k_cache: Array, v_cache: Array, q_position: Array, window: int,
) -> Array:
    """Single-token decode attention against a cache.

    q: (B, 1, H, hd); k/v_cache: (B, S, Hkv, hd); q_position: (B,) int.
    Entries beyond q_position (or outside the window) are masked."""
    b, s, hkv, hd = k_cache.shape
    groups = q.shape[2] // hkv
    k = _repeat_kv(k_cache, groups)
    v = _repeat_kv(v_cache, groups)
    scale = hd**-0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    kpos = torch.arange(s, dtype=torch.int64, device=q.device)
    dq = q_position.to(torch.int64)[:, None]  # (B, 1)
    visible = kpos[None, :] <= dq
    if int(window) != GLOBAL:
        visible = visible & ((dq - kpos[None, :]) < max(int(window), 1))
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    bias = torch.where(visible, zero, torch.full_like(zero, _NEG_INF))  # (B, S)
    probs = torch.softmax(scores + bias[:, None, None, :], dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def select_attention(
    impl: str, q: Array, k: Array, v: Array, q_positions: Array,
    k_positions: Array, window: int, *, chunk_q: int = 512, chunk_kv: int = 1024,
    bidirectional: bool = False,
) -> Array:
    """Dispatch on attn_impl. ``window`` is a Python int: the layers run
    as a Python loop, so it reaches the kernel as one."""
    del chunk_q, chunk_kv  # read only by the chunked path, not ported yet
    if impl == "auto":
        impl = "xla" if k.shape[1] <= 8192 else "xla_chunked"
    if impl == "xla":
        return attention_xla(
            q, k, v, q_positions, k_positions, window, bidirectional=bidirectional
        )
    if impl == "xla_chunked":
        raise NotImplementedError(
            "attn_impl='xla_chunked' is not ported yet: ROADMAP.md queue 1, "
            "item 10(b) (the model families) brings it"
        )
    if impl == "flash":
        from repro_torch.kernels.flash_attention import ops as flash_ops

        return flash_ops.flash_attention(
            q, k, v, q_positions, k_positions, window, bidirectional=bidirectional
        )
    raise ValueError(f"unknown attn impl {impl}")
