"""Decoder-only LM trunk, DENSE, MOE, HYBRID and VLM families (port of
``repro/models/transformer.py``). A config with ``num_experts`` swaps the
dense gated MLP for the MoE FFN of ``models/moe.py``, chosen by
``Runtime.moe_impl`` (default ``"dropless"``, the served route). HYBRID
(hymba) runs a Mamba-style SSM branch beside attention in every layer
and averages the two (``_ssm_branch``, through ``ssm.selective_scan``);
VLM (internvl2) prepends its patch embeddings to the embedded tokens
(``embed_inputs``).

Parameters keep the JAX package's stacked layout (a leading
``num_layers`` dim, ``wq`` as (L, d, H, hd), ``wo`` as (L, H, hd, d)), so
one parameter tree serves both packages through ``convert``. The layers
run as a Python loop (the JAX package scans them): each layer's window
and RoPE theta are Python values, so the flash path hands K5 its window
as an int.

Serving: :func:`prefill` returns the last position's logits and a
contiguous KV cache; :func:`decode_step` advances it one token. The
cache is a dict ``{"k", "v": (L, B, S, Hkv, hd), "pos": int}`` (HYBRID
adds float32 ``ssm_state`` (L, B, d_inner, ssm_state) and ``conv_state``
(L, B, ssm_conv - 1, d_inner)) that ``decode_step`` updates IN PLACE (its
caller owns it, as the JAX package's callers donate it) and returns.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import GLOBAL, Family, ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    attention_xla,
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
    fields belong to the distributed path (ROADMAP item 11(b)); the port's
    single-device path reads only ``moe_impl``. ``tensor`` (a
    ``dist.tensor_parallel.TensorParallel``) runs the DENSE training loss
    on this rank's parameter blocks (``lm_loss``; see ``_tp_trunk``)."""

    mesh: Any = None
    batch_axes: tuple[str, ...] = ("data",)
    expert_axis: str | None = None
    tp_axis: str | None = None
    moe_impl: str = "dropless"
    moe_group_axes: tuple[str, ...] = ()
    tensor: Any = None


def check_trunk(cfg: ModelConfig) -> None:
    """The families this trunk builds: DENSE, MOE, HYBRID and VLM (SSM is
    ``models/rwkv6``, ENCDEC ``models/encdec``)."""
    if cfg.family not in (Family.DENSE, Family.MOE, Family.HYBRID, Family.VLM):
        raise ValueError(
            f"{cfg.name}: family {cfg.family.value} is not a decoder-only "
            "transformer trunk"
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
    if cfg.family is Family.HYBRID:
        di, st, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
        layers.update(
            ssm_norm=ParamDecl((L, d), ("layers", "embed"), "zeros", pd),
            ssm_in=ParamDecl((L, d, 2 * di), ("layers", "embed", "ssm"), "normal", pd),
            ssm_conv=ParamDecl((L, di, cfg.ssm_conv), ("layers", "ssm", None), "normal", pd),
            ssm_xproj=ParamDecl((L, di, dtr + 2 * st), ("layers", "ssm", None), "normal", pd),
            ssm_dtproj=ParamDecl((L, dtr, di), ("layers", None, "ssm"), "normal", pd),
            ssm_a_log=ParamDecl((L, di, st), ("layers", "ssm", None), "zeros", "float32"),
            ssm_d=ParamDecl((L, di), ("layers", "ssm"), "ones", "float32"),
            ssm_dt_bias=ParamDecl((L, di), ("layers", "ssm"), "zeros", "float32"),
            ssm_out=ParamDecl((L, di, d), ("layers", "ssm", "embed"), "normal_out", pd),
        )
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


def _ssm_branch(lp, cfg: ModelConfig, x: Array, state=None, conv_state=None):
    """Mamba-style branch of the hybrid family (full-sequence form) on
    pre-normed x (B, S, d). Returns (out (B, S, d), final SSM state
    (B, d_inner, ssm_state) f32, final conv window (B, ssm_conv - 1,
    d_inner) f32: the last inputs of the causal depthwise conv)."""
    s, st, dtr = x.shape[1], cfg.ssm_state, cfg.dt_rank
    xs, z = torch.chunk(x @ lp["ssm_in"], 2, dim=-1)  # (B, S, d_inner) each
    # causal depthwise conv along time, over a zero (or given) history
    w = lp["ssm_conv"].float()  # (di, conv)
    pad = cfg.ssm_conv - 1
    xpad = torch.nn.functional.pad(xs.float(), (0, 0, pad, 0))
    if conv_state is not None:
        xpad[:, :conv_state.shape[1]] = conv_state
    xc = sum(xpad[:, i:i + s] * w[:, i] for i in range(cfg.ssm_conv))
    xc = torch.nn.functional.silu(xc).to(x.dtype)
    final_conv = xpad[:, s:s + pad]
    dt_r, b_in, c_in = torch.split(xc @ lp["ssm_xproj"], [dtr, st, st], dim=-1)
    dt = torch.nn.functional.softplus(dt_r @ lp["ssm_dtproj"] + lp["ssm_dt_bias"])
    y, s_final = ssm_mod.selective_scan(xc, dt, lp["ssm_a_log"], b_in, c_in, lp["ssm_d"],
                                        initial_state=state)
    y = y * torch.nn.functional.silu(z)
    return y @ lp["ssm_out"], s_final, final_conv


def _ssm_decode_step(lp, cfg: ModelConfig, x: Array, ssm_state: Array, conv_state: Array):
    """One-token hybrid SSM branch on pre-normed x (B, 1, d), from the
    slot's ``ssm_state`` (B, di, st) and ``conv_state`` (B, conv - 1, di).
    Returns (out (B, 1, d), new ssm_state, new conv_state), both f32."""
    st, dtr = cfg.ssm_state, cfg.dt_rank
    xs, z = torch.chunk(x[:, 0] @ lp["ssm_in"], 2, dim=-1)  # (B, di) each
    # roll the conv window: conv_state holds the previous inputs
    hist = torch.cat([conv_state.float(), xs.float()[:, None, :]], dim=1)  # (B, conv, di)
    xc = torch.einsum("bci,ic->bi", hist, lp["ssm_conv"].float())
    xc = torch.nn.functional.silu(xc).to(x.dtype)
    dt_r, b_in, c_in = torch.split(xc @ lp["ssm_xproj"], [dtr, st, st], dim=-1)
    dt = torch.nn.functional.softplus(dt_r @ lp["ssm_dtproj"] + lp["ssm_dt_bias"])
    y, s_new = ssm_mod.selective_scan_step(xc, dt, lp["ssm_a_log"], b_in, c_in,
                                           lp["ssm_d"], ssm_state)
    y = y * torch.nn.functional.silu(z)
    return (y @ lp["ssm_out"])[:, None], s_new, hist[:, 1:]


def _hybrid_layer(lp, cfg: ModelConfig, x: Array, positions: Array, window: int,
                  theta: float, runtime: Runtime):
    """One hybrid block: attention and the SSM branch on the same input,
    averaged. Returns (x', (k, v), ssm_state, conv_state)."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    a, kv = _attn_block(lp, cfg, h, positions, window, theta)
    hs = rms_norm(x, lp["ssm_norm"], cfg.rms_eps)
    ssm_out, s_state, c_state = _ssm_branch(lp, cfg, hs)
    x = x + 0.5 * (a + ssm_out)
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + _ffn_block(lp, cfg, h, runtime), kv, s_state, c_state


def _layer_fwd(lp, cfg: ModelConfig, x: Array, positions: Array, window: int,
               theta: float, runtime: Runtime = Runtime()):
    """One transformer block (prefill form). Returns (x', (k, v))."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    a, kv = _attn_block(lp, cfg, h, positions, window, theta)
    x = x + a
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + _ffn_block(lp, cfg, h, runtime), kv


# --------------------------------------------------------------------- #
# The layer on this rank's blocks (Runtime.tensor; DENSE, training)
# --------------------------------------------------------------------- #
def _tp_attn_block(lp, cfg: ModelConfig, tp, x: Array, positions: Array, window: int,
                   theta: float) -> Array:
    """Self-attention on this rank's query heads and ``head_dim`` columns:
    column-parallel q / k / v (the kv heads its query heads read, all of
    them held where kv does not divide over tp), q and k made whole over
    ``head_dim`` for ``qk_norm`` and RoPE (which pair i with i + hd/2),
    the scores then replicated over sp and the probabilities read by the
    split v, then the row-parallel output reduced over the attention
    axes. Returns the replicated (B, S, d) output."""
    hc = tp.copy(x, tp.attn_axes)
    u0, u1 = tp.kv_used
    q = _proj(hc, lp["wq"])
    k, v = _proj(hc, lp["wk"][:, u0:u1]), _proj(hc, lp["wv"][:, u0:u1])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"][u0:u1], v + lp["bv"][u0:u1]
    q, k = tp.gather(q, tp.hd_axes), tp.gather(k, tp.hd_axes)
    if cfg.qk_norm:
        q = rms_norm(q, tp.gather(lp["q_norm"], tp.hd_axes), cfg.rms_eps)
        k = rms_norm(k, tp.gather(lp["k_norm"], tp.hd_axes), cfg.rms_eps)
    q, k = apply_rope(q, positions, theta), apply_rope(k, positions, theta)
    if tp.hd_axes:
        if cfg.attn_impl not in ("auto", "xla") or k.shape[1] > 8192:
            raise NotImplementedError(
                f"attention {cfg.attn_impl!r} over {k.shape[1]} keys with head_dim split "
                "over sp: only the materialised-score path is executed (ROADMAP.md queue "
                "1, item 11(b))")
        out = attention_xla(q, k, v, positions, positions, window,
                            probs_hook=lambda p: tp.copy(p, tp.hd_axes))
    else:
        out = select_attention(cfg.attn_impl, q, k, v, positions, positions, window,
                               chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    return tp.reduce(attn_out(lp, out), tp.attn_axes)


def _tp_layers(params, tp) -> list[dict[str, Array]]:
    """Every layer's blocks (``unstacked_layers``), each stacked leaf that
    split computation reads while it is replicated behind one ``copy``
    over those axes (``TensorParallel.leaf_copies``)."""
    return unstacked_layers({"layers": {
        k: tp.copy(v, tp.leaf_copies.get(k, ())) for k, v in params["layers"].items()}})


def _tp_trunk(params, cfg: ModelConfig, tp, tokens: Array) -> Array:
    """The vocabulary-parallel embedding (a masked lookup of the rows this
    rank holds, then a reduce), every layer on this rank's blocks and the
    final norm. A replicated leaf that split computation reads (kv
    heads that do not divide over tp, ``qk_norm``) passes a ``copy``
    first, so its gradient is summed over those ranks once. Returns the
    replicated normed hidden (B, S, d)."""
    lo, hi = tp.vocab
    if tp.vocab_axes:
        t = tokens.to(torch.int64) - lo
        here = (t >= 0) & (t < hi - lo)
        e = params["embed"][torch.clamp(t, 0, hi - lo - 1)]
        x = tp.reduce(torch.where(here[..., None], e, torch.zeros_like(e[:1, :1])),
                      tp.vocab_axes)
    else:
        x = params["embed"][tokens]
    if cfg.scale_embeddings:
        x = x * torch.full((), cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    positions = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    for i, lp in enumerate(_tp_layers(params, tp)):
        w_i, th_i = static_layer_meta(cfg, i)
        x = x + _tp_attn_block(lp, cfg, tp, rms_norm(x, lp["attn_norm"], cfg.rms_eps),
                               positions, w_i, th_i)
        h = tp.copy(rms_norm(x, lp["mlp_norm"], cfg.rms_eps), tp.mlp_axes)
        x = x + tp.reduce(gated_mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.act),
                          tp.mlp_axes)
    return rms_norm(x, params["final_norm"], cfg.rms_eps)


def _single_device(runtime: Runtime) -> None:
    if getattr(runtime, "tensor", None) is not None:
        raise NotImplementedError(
            "the forward and serving paths on tensor-parallel blocks are not executed "
            "(the training loss is): ROADMAP.md queue 1, item 11(b), step 3")


def _tp_ce(params, cfg: ModelConfig, tp):
    """``_chunked_ce``'s chunk loss on this rank's vocabulary rows: the
    float32 logits of its block (softcap and the padded rows' mask as in
    ``_head_logits``) through the vocabulary-parallel cross-entropy."""

    def ce(h_c, t_c, m_c):
        logits = _head_logits(params, cfg, h_c, tp.vocab)
        if tp.vocab_axes:
            per = tp.vocab_ce(logits, t_c)
        else:
            gold = torch.gather(logits, -1, t_c[..., None].to(torch.int64))[..., 0]
            per = torch.logsumexp(logits, dim=-1) - gold
        return torch.sum(per * m_c), torch.sum(m_c)

    return ce


# --------------------------------------------------------------------- #
# Forward
# --------------------------------------------------------------------- #
def embed_inputs(params, cfg: ModelConfig, tokens=None, embeds=None):
    """Token ids and/or precomputed frontend embeddings -> (B, S, d). The
    VLM stub's ``embeds`` (patch embeddings) are prepended to the embedded
    tokens."""
    parts = []
    if embeds is not None:
        parts.append(embeds.to(getattr(torch, cfg.compute_dtype)))
    if tokens is not None:
        parts.append(params["embed"][tokens])
    x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    if cfg.scale_embeddings:
        x = x * torch.full((), cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def _trunk(params, cfg: ModelConfig, tokens, embeds, runtime: Runtime, keep: bool):
    """Embed and run every layer. Returns (normed hidden (B, S, d), the
    layers' (k, v) and, for HYBRID, their final (ssm_state, conv_state):
    lists, empty unless ``keep``)."""
    check_trunk(cfg)
    _single_device(runtime)
    x = embed_inputs(params, cfg, tokens, embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    kvs, states = [], []
    for i, lp in enumerate(unstacked_layers(params)):
        w_i, th_i = static_layer_meta(cfg, i)
        if cfg.family is Family.HYBRID:
            x, kv, ss, cs = _hybrid_layer(lp, cfg, x, positions, w_i, th_i, runtime)
            if keep:
                states.append((ss, cs))
        else:
            x, kv = _layer_fwd(lp, cfg, x, positions, w_i, th_i, runtime)
        if keep:
            kvs.append(kv)
    return rms_norm(x, params["final_norm"], cfg.rms_eps), kvs, states


def forward_hidden(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                   runtime=Runtime(), return_kv: bool = False):
    """Full-sequence forward. Returns hidden (B,S,d) [, stacked (k, v) of
    shape (L, B, S, Hkv, hd) each]."""
    x, kvs, _ = _trunk(params, cfg, tokens, embeds, runtime, return_kv)
    if not return_kv:
        return x
    return x, tuple(torch.stack(t) for t in zip(*kvs))


def _head_logits(params, cfg: ModelConfig, h: Array, vocab: tuple[int, int] | None = None
                 ) -> Array:
    """Float32 logits of hidden ``h``; ``vocab`` (lo, hi): the head holds
    those vocabulary rows only (a tensor-parallel block)."""
    w = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    logits = (h @ w).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab_size:  # mask padded rows to -inf
        lo, hi = vocab or (0, cfg.padded_vocab)
        pad = torch.arange(lo, hi, device=logits.device) >= cfg.vocab_size
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
    tp = getattr(runtime, "tensor", None)  # any object without the field: one device
    if tp is not None:
        h = _tp_trunk(params, cfg, tp, tokens)[:, -targets.shape[1]:]
        return _chunked_ce(params, cfg, tp.copy(h, tp.vocab_axes), targets, loss_mask,
                           ce=_tp_ce(params, cfg, tp))
    h = forward_hidden(params, cfg, tokens=tokens, embeds=embeds, runtime=runtime)
    # targets are the next-token predictions of the LAST targets.shape[1]
    # positions
    h = h[:, -targets.shape[1]:]
    return _chunked_ce(params, cfg, h, targets, loss_mask)


def _chunked_ce(params, cfg: ModelConfig, h: Array, targets: Array, loss_mask, ce=None):
    """Cross-entropy over ``cfg.loss_chunk``-position chunks of the
    sequence (the last chunk padded with masked positions), summed over
    chunks in order and divided by the unmasked count. ``ce(h_c, t_c,
    m_c)`` -> (masked sum, count) of a chunk; by default over the whole
    vocabulary."""
    tlen = targets.shape[1]
    if loss_mask is None:
        loss_mask = torch.ones(targets.shape, dtype=torch.float32, device=h.device)

    def whole_ce(h_c, t_c, m_c):
        logits = _head_logits(params, cfg, h_c)  # (B, chunk, V) f32
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t_c[..., None].to(torch.int64))[..., 0]
        return torch.sum((logz - gold) * m_c), torch.sum(m_c)

    ce = ce or whole_ce

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
def ssm_states(cfg: ModelConfig, batch: int, device) -> dict[str, Array]:
    """A HYBRID config's zeroed float32 ``ssm_state`` (L, batch, d_inner,
    ssm_state) and ``conv_state`` (L, batch, ssm_conv - 1, d_inner)."""
    L, di = cfg.num_layers, cfg.d_inner
    f = dict(dtype=torch.float32, device=device)
    return {"ssm_state": torch.zeros((L, batch, di, cfg.ssm_state), **f),
            "conv_state": torch.zeros((L, batch, cfg.ssm_conv - 1, di), **f)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None):
    """A zeroed cache on the CUDA card unless ``device`` names another."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    device = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
    }
    if cfg.family is Family.HYBRID:
        cache.update(ssm_states(cfg, batch, device))
    return cache


def prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None, cache_len: int,
            runtime=Runtime()):
    """Run the full prompt: (last-position logits (B,1,V) f32, cache with
    the prompt's KV in rows [0, S) and zeros up to ``cache_len``; HYBRID's
    with every layer's final SSM and conv states)."""
    h, kvs, states = _trunk(params, cfg, tokens, embeds, runtime, True)
    k, v = (torch.stack(t) for t in zip(*kvs))
    s = k.shape[2]
    pad = cache_len - s
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    cache = {"k": k, "v": v, "pos": s}
    if states:
        cache["ssm_state"], cache["conv_state"] = (torch.stack(t) for t in zip(*states))
    return _head_logits(params, cfg, h[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, runtime=Runtime()):
    """One-token decode. tokens: (B, 1) int. Writes the new KV into
    ``cache`` in place, advances ``cache["pos"]`` and returns
    (logits (B,1,V) f32, cache)."""
    check_trunk(cfg)
    _single_device(runtime)
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
        a = attn_out(lp, out)
        if cfg.family is Family.HYBRID:
            a = 0.5 * (a + hybrid_decode(lp, cfg, x, cache, i))
        x = x + a
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + _ffn_block(lp, cfg, h, runtime)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    cache["pos"] = pos + 1
    return _head_logits(params, cfg, x), cache


def hybrid_decode(lp, cfg: ModelConfig, x: Array, states, i: int) -> Array:
    """Layer i's SSM branch for one token of x (B, 1, d), un-normed: reads
    and writes ``states["ssm_state"][i]`` and ``states["conv_state"][i]``
    in place. Returns the branch's output (B, 1, d)."""
    hs = rms_norm(x, lp["ssm_norm"], cfg.rms_eps)
    out, ss, cs = _ssm_decode_step(lp, cfg, hs, states["ssm_state"][i],
                                   states["conv_state"][i])
    states["ssm_state"][i] = ss
    states["conv_state"][i] = cs
    return out
