"""Decoder-only LM trunk, DENSE and MOE families (port of
``repro/models/transformer.py``). A config with ``num_experts`` swaps the
dense gated MLP for the MoE FFN of ``models/moe.py``, chosen by
``Runtime.moe_impl`` (default ``"dropless"``, the served route).

Parameters keep the JAX package's stacked layout (a leading
``num_layers`` dim, ``wq`` as (L, d, H, hd), ``wo`` as (L, H, hd, d)), so
one parameter tree serves both packages through ``convert``. The layers
run as a Python loop (the JAX package scans them): each layer's window
and RoPE theta are Python values, so the flash path hands K5 its window
as an int.

Serving: :func:`prefill` returns the last position's logits and a
contiguous KV cache; :func:`decode_step` advances it one token. The
cache is a dict ``{"k", "v": (L, B, S, Hkv, hd), "pos": int}`` that
``decode_step`` updates IN PLACE (its caller owns it, as the JAX
package's callers donate it) and returns.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import GLOBAL, Family, ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    attention_decode,
    gated_mlp,
    rms_norm,
    select_attention,
)
from repro_torch.models.params import ParamDecl, init_tree

Array = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through the apply functions. The mesh
    fields belong to the distributed path (ROADMAP item 11); the port's
    single-device path reads only ``moe_impl``."""

    mesh: Any = None
    batch_axes: tuple[str, ...] = ("data",)
    expert_axis: str | None = None
    tp_axis: str | None = None
    moe_impl: str = "dropless"
    moe_group_axes: tuple[str, ...] = ()


def check_trunk(cfg: ModelConfig) -> None:
    """The trunk families the port builds: DENSE and MOE."""
    if cfg.family not in (Family.DENSE, Family.MOE):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family.value} is not ported yet: "
            "ROADMAP.md queue 1, item 10(b2) (the HYBRID, VLM and ENCDEC "
            "families) ports it"
        )


# --------------------------------------------------------------------- #
# Parameter declarations
# --------------------------------------------------------------------- #
def param_decls(cfg: ModelConfig):
    check_trunk(cfg)
    L, d, H, Hkv, hd = (
        cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
    )
    ff, V = cfg.d_ff, cfg.padded_vocab
    pd = cfg.param_dtype
    layers: dict[str, ParamDecl] = {
        "attn_norm": ParamDecl((L, d), ("layers", "embed"), "zeros", pd),
        "mlp_norm": ParamDecl((L, d), ("layers", "embed"), "zeros", pd),
        "wq": ParamDecl((L, d, H, hd), ("layers", "embed", "heads", "head_dim"), "normal", pd),
        "wk": ParamDecl((L, d, Hkv, hd), ("layers", "embed", "kv", "head_dim"), "normal", pd),
        "wv": ParamDecl((L, d, Hkv, hd), ("layers", "embed", "kv", "head_dim"), "normal", pd),
        "wo": ParamDecl((L, H, hd, d), ("layers", "heads", "head_dim", "embed"), "normal_out", pd),
    }
    if cfg.num_experts:
        E = cfg.num_experts
        layers["w_router"] = ParamDecl((L, d, E), ("layers", "embed", None), "normal", pd)
        layers["we_gate"] = ParamDecl((L, E, d, ff), ("layers", "experts", "embed", "expert_mlp"), "normal", pd)
        layers["we_up"] = ParamDecl((L, E, d, ff), ("layers", "experts", "embed", "expert_mlp"), "normal", pd)
        layers["we_down"] = ParamDecl((L, E, ff, d), ("layers", "experts", "expert_mlp", "embed"), "normal_out", pd)
    else:
        layers["w_gate"] = ParamDecl((L, d, ff), ("layers", "embed", "mlp"), "normal", pd)
        layers["w_up"] = ParamDecl((L, d, ff), ("layers", "embed", "mlp"), "normal", pd)
        layers["w_down"] = ParamDecl((L, ff, d), ("layers", "mlp", "embed"), "normal_out", pd)
    if cfg.qkv_bias:
        layers["bq"] = ParamDecl((L, H, hd), ("layers", "heads", "head_dim"), "zeros", pd)
        layers["bk"] = ParamDecl((L, Hkv, hd), ("layers", "kv", "head_dim"), "zeros", pd)
        layers["bv"] = ParamDecl((L, Hkv, hd), ("layers", "kv", "head_dim"), "zeros", pd)
    if cfg.qk_norm:
        layers["q_norm"] = ParamDecl((L, hd), ("layers", "head_dim"), "zeros", pd)
        layers["k_norm"] = ParamDecl((L, hd), ("layers", "head_dim"), "zeros", pd)
    decls = {
        "embed": ParamDecl((V, d), ("vocab", "embed"), "normal", pd),
        "layers": layers,
        "final_norm": ParamDecl((d,), ("embed",), "zeros", pd),
    }
    if not cfg.tie_embeddings:
        decls["lm_head"] = ParamDecl((d, V), ("embed", "vocab"), "normal_out", pd)
    return decls


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """Random parameters on ``generator``'s device."""
    return init_tree(param_decls(cfg), generator)


# --------------------------------------------------------------------- #
# Per-layer metadata
# --------------------------------------------------------------------- #
def static_layer_meta(cfg: ModelConfig, i: int) -> tuple[int, float]:
    """Python (window, rope_theta) of layer i."""
    w = cfg.layer_windows()[i]
    theta = cfg.rope_theta_global if w == GLOBAL else cfg.rope_theta_local
    return int(w), float(theta)


def layer_params(params, i: int) -> dict[str, Array]:
    """Layer i's slice of the stacked parameters (views)."""
    return {k: v[i] for k, v in params["layers"].items()}


def unstacked_layers(params) -> list[dict[str, Array]]:
    """Every layer's slice of the stacked parameters from ONE ``unbind``
    per leaf: views, whose backward is one stack per leaf. (Indexing each
    layer instead makes the backward add L zero-padded full-size gradients
    into every leaf: for llama3.2-1b's 16 layers on an H100, 307 of the
    877 ms of kernel time of a training round.)"""
    cols = {k: v.unbind(0) for k, v in params["layers"].items()}
    n = len(next(iter(cols.values())))
    return [{k: cols[k][i] for k in cols} for i in range(n)]


# --------------------------------------------------------------------- #
# Layer body
# --------------------------------------------------------------------- #
def _proj(x: Array, w: Array) -> Array:
    """(..., d) @ (d, H, hd) -> (..., H, hd)."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).unflatten(-1, (h, hd))


def qkv(lp, cfg: ModelConfig, h: Array, positions: Array, theta: float):
    """Projected, biased, normed and rotated (q, k, v) of normed input h."""
    q, k, v = _proj(h, lp["wq"]), _proj(h, lp["wk"]), _proj(h, lp["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_eps)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def attn_out(lp, out: Array) -> Array:
    """(B, S, H, hd) attention output @ wo (H, hd, d) -> (B, S, d)."""
    h, hd, d = lp["wo"].shape
    return out.flatten(-2) @ lp["wo"].reshape(h * hd, d)


def _attn_block(lp, cfg: ModelConfig, x: Array, positions: Array, window: int,
                theta: float):
    """Self-attention sub-block on pre-normed x (B,S,d) -> (out, (k, v))."""
    q, k, v = qkv(lp, cfg, x, positions, theta)
    out = select_attention(
        cfg.attn_impl, q, k, v, positions, positions, window,
        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
    )
    return attn_out(lp, out), (k, v)


def _ffn_block(lp, cfg: ModelConfig, x: Array, runtime: Runtime = Runtime()):
    """The dense gated MLP, or the MoE FFN that ``runtime.moe_impl`` names
    ("dropless", "gshard", "ep"; anything else the reference)."""
    if not cfg.num_experts:
        return gated_mlp(x, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.act)
    args = (x, lp["w_router"], lp["we_gate"], lp["we_up"], lp["we_down"], cfg)
    if runtime.moe_impl == "ep":
        return moe_mod.moe_ffn_ep(*args, runtime.mesh, batch_axes=runtime.batch_axes,
                                  expert_axis=runtime.expert_axis, tp_axis=runtime.tp_axis)
    if runtime.moe_impl == "gshard":
        return moe_mod.moe_ffn_gshard(*args, mesh=runtime.mesh,
                                      expert_axis=runtime.expert_axis,
                                      group_axes=runtime.moe_group_axes,
                                      tp_axis=runtime.tp_axis)
    if runtime.moe_impl == "dropless":
        return moe_mod.moe_ffn_dropless(*args)
    return moe_mod.moe_ffn_reference(*args)


def _layer_fwd(lp, cfg: ModelConfig, x: Array, positions: Array, window: int,
               theta: float, runtime: Runtime = Runtime()):
    """One transformer block (prefill form). Returns (x', (k, v))."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    a, kv = _attn_block(lp, cfg, h, positions, window, theta)
    x = x + a
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + _ffn_block(lp, cfg, h, runtime), kv


# --------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------- #
def embed_inputs(params, cfg: ModelConfig, tokens=None, embeds=None):
    """Token ids and/or precomputed frontend embeddings -> (B, S, d)."""
    parts = []
    if embeds is not None:
        parts.append(embeds.to(getattr(torch, cfg.compute_dtype)))
    if tokens is not None:
        parts.append(params["embed"][tokens])
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    if cfg.scale_embeddings:
        x = x * torch.full((), cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def forward_hidden(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                   runtime=Runtime(), return_kv: bool = False):
    """Full-sequence forward. Returns hidden (B,S,d) [, stacked (k, v) of
    shape (L, B, S, Hkv, hd) each]."""
    check_trunk(cfg)
    x = embed_inputs(params, cfg, tokens, embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    ks, vs = [], []
    for i, lp in enumerate(unstacked_layers(params)):
        w_i, th_i = static_layer_meta(cfg, i)
        x, (k, v) = _layer_fwd(lp, cfg, x, positions, w_i, th_i, runtime)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return (x, (torch.stack(ks), torch.stack(vs))) if return_kv else x


def _head_logits(params, cfg: ModelConfig, h: Array) -> Array:
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ w).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab_size:  # mask padded rows to -inf
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def lm_loss(params, cfg: ModelConfig, *, tokens=None, embeds=None, targets,
            loss_mask=None, runtime=Runtime()):
    """Next-token cross-entropy, sequence-chunked so the full (B, S, V)
    logits never exist at once. Attention runs on the plain path
    (``"auto"`` and ``"xla"``): K5 is forward-only in both packages, so
    a loss asked of ``attn_impl="flash"`` raises rather than train on
    another path."""
    if cfg.attn_impl == "flash":
        raise NotImplementedError(
            "lm_loss with attn_impl='flash': K5 (flash_attention_fwd) has no "
            "backward in either package; train with attn_impl 'auto' or 'xla'"
        )
    h = forward_hidden(params, cfg, tokens=tokens, embeds=embeds, runtime=runtime)
    # targets are the next-token predictions of the LAST targets.shape[1]
    # positions
    h = h[:, -targets.shape[1]:]
    return _chunked_ce(params, cfg, h, targets, loss_mask)


def _chunked_ce(params, cfg: ModelConfig, h: Array, targets: Array, loss_mask):
    """Cross-entropy over ``cfg.loss_chunk``-position chunks of the
    sequence (the last chunk padded with masked positions), summed over
    chunks in order and divided by the unmasked count."""
    tlen = targets.shape[1]
    if loss_mask is None:
        loss_mask = torch.ones(targets.shape, dtype=torch.float32, device=h.device)

    def ce(h_c, t_c, m_c):
        logits = _head_logits(params, cfg, h_c)  # (B, chunk, V) f32
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t_c[..., None].to(torch.int64))[..., 0]
        return torch.sum((logz - gold) * m_c), torch.sum(m_c)

    chunk = cfg.loss_chunk
    if not chunk or tlen <= chunk:
        total, count = ce(h, targets, loss_mask)
    else:
        n = -(-tlen // chunk)
        pad = n * chunk - tlen

        def padded(a):
            if not pad:
                return a
            return torch.cat([a, torch.zeros((a.shape[0], pad) + tuple(a.shape[2:]),
                                              dtype=a.dtype, device=a.device)], dim=1)

        hp, tp, mp = padded(h), padded(targets), padded(loss_mask)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        count = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            s, c = ce(hp[:, sl], tp[:, sl], mp[:, sl])
            total, count = total + s, count + c
    return total / torch.clamp(count, min=1.0)


# --------------------------------------------------------------------- #
# Serving: prefill + single-token decode
# --------------------------------------------------------------------- #
def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None):
    """A zeroed cache on the CUDA card unless ``device`` names another."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
    }


def prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None, cache_len: int,
            runtime=Runtime()):
    """Run the full prompt: (last-position logits (B,1,V) f32, cache with
    the prompt's KV in rows [0, S) and zeros up to ``cache_len``)."""
    h, (k, v) = forward_hidden(params, cfg, tokens=tokens, embeds=embeds,
                               runtime=runtime, return_kv=True)
    s = k.shape[2]
    pad = cache_len - s
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    logits = _head_logits(params, cfg, h[:, -1:])
    return logits, {"k": k, "v": v, "pos": s}


def decode_step(params, cfg: ModelConfig, cache, tokens, runtime=Runtime()):
    """One-token decode. tokens: (B, 1) int. Writes the new KV into
    ``cache`` in place, advances ``cache["pos"]`` and returns
    (logits (B,1,V) f32, cache)."""
    check_trunk(cfg)
    pos = int(cache["pos"])
    x = embed_inputs(params, cfg, tokens=tokens)
    b = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q_pos = torch.full((b,), pos, dtype=torch.int64, device=x.device)
    k_all, v_all = cache["k"], cache["v"]
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        w_i, th_i = static_layer_meta(cfg, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = qkv(lp, cfg, h, positions, th_i)
        k_all[i, :, pos] = k[:, 0]
        v_all[i, :, pos] = v[:, 0]
        out = attention_decode(q, k_all[i], v_all[i], q_pos, w_i)
        x = x + attn_out(lp, out)
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _ffn_block(lp, cfg, h, runtime)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    cache["pos"] = pos + 1
    return _head_logits(params, cfg, x), cache
