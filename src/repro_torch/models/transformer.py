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
caller owns it, as the JAX package's callers donate it) and returns;
:func:`greedy` picks the next tokens from the logits.

Under mesh rules (DENSE only; every other family raises, naming ROADMAP
item 11(b)) the same functions run on one rank's share:
``Runtime.tensor`` (``dist.tensor_parallel.TensorParallel``) computes the
rank's query heads and vocabulary rows: the logits are the rank's
vocabulary block, the cache holds its kv heads (whole ``head_dim``) and
:func:`greedy` is the vocabulary-parallel pick. ``Runtime.sequence``
(``SequenceParallel``) prefills the rank's span of the prompt against the
whole prompt's keys, keeps the cache positions ``cache["span"]`` and
merges each decode step's attention over the ranks. The two compose.
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
    attention_decode,
    attention_decode_partial,
    gated_mlp,
    rms_norm,
    select_attention,
    span_attention,
)
from repro_torch.models.params import ParamDecl, init_tree

Array = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context threaded through the apply functions. The mesh
    fields belong to the distributed path (ROADMAP item 11(b)); the port's
    single-device path reads only ``moe_impl``. ``tensor`` (a
    ``dist.tensor_parallel.TensorParallel``) runs the DENSE training loss
    (``lm_loss``) and serving on this rank's parameter blocks, through the
    same layer (``layer_qkv``, ``layer_attn_out``, ``layer_ffn``);
    ``sequence`` (a ``SequenceParallel``) runs DENSE static serving on
    this rank's span of the prompt and the cache."""

    mesh: Any = None
    batch_axes: tuple[str, ...] = ("data",)
    expert_axis: str | None = None
    tp_axis: str | None = None
    moe_impl: str = "dropless"
    moe_group_axes: tuple[str, ...] = ()
    tensor: Any = None
    sequence: Any = None


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
                theta: float, runtime=Runtime(), lo: int = 0):
    """Self-attention sub-block on pre-normed x (B,S,d) -> (out, (k, v)).
    Under ``runtime.tensor`` on the rank's heads; under ``runtime.sequence``
    x is the span [lo, lo + S) of the prompt, whose queries attend to the
    whole prompt's keys and values, gathered over the split (the (k, v)
    returned)."""
    q, k, v = layer_qkv(lp, cfg, x, positions, theta, runtime)
    seq = getattr(runtime, "sequence", None)
    if seq is None:
        out = select_attention(cfg.attn_impl, q, k, v, positions, positions, window,
                               chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    else:
        k, v = torch.split(seq.gather(torch.cat([k, v], dim=-2)), k.shape[-2], dim=-2)
        out = span_attention(cfg.attn_impl, q, k, v, lo, window,
                             chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    return layer_attn_out(lp, out, runtime), (k, v)


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
               theta: float, runtime: Runtime = Runtime(), lo: int = 0):
    """One transformer block (prefill form; ``runtime`` and ``lo`` as in
    ``_attn_block``). Returns (x', (k, v))."""
    h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
    a, kv = _attn_block(lp, cfg, h, positions, window, theta, runtime, lo)
    x = x + a
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + layer_ffn(lp, cfg, h, runtime), kv


def _tp_layers(params, tp) -> list[dict[str, Array]]:
    """Every layer's blocks (``unstacked_layers``), each stacked leaf that
    split computation reads while it is replicated behind one ``copy``
    over those axes (``TensorParallel.leaf_copies``), so its gradient is
    summed over those ranks once."""
    return unstacked_layers({"layers": {
        k: tp.copy(v, tp.leaf_copies.get(k, ())) for k, v in params["layers"].items()}})


def check_split(cfg: ModelConfig, runtime) -> tuple[Any, Any]:
    """``runtime``'s (tensor, sequence) views; a family other than DENSE
    under either raises (ROADMAP item 11(b))."""
    tp = getattr(runtime, "tensor", None)
    seq = getattr(runtime, "sequence", None)
    if (tp is not None or seq is not None) and cfg.family is not Family.DENSE:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family on a model or sequence split is "
            "not executed yet; DENSE only: ROADMAP.md queue 1, item 11(b)")
    return tp, seq


# --------------------------------------------------------------------- #
# The layer on a rank's blocks (the single-device ops without one), for
# the training loss and serving alike
# --------------------------------------------------------------------- #
def embed_tokens(params, cfg: ModelConfig, tokens: Array, runtime=Runtime()) -> Array:
    """(B, S) token ids -> (B, S, d); under ``runtime.tensor`` with the
    vocabulary split, a masked lookup of the rows this rank holds, then a
    reduce."""
    tp = getattr(runtime, "tensor", None)
    if tp is None or not tp.vocab_axes:
        return embed_inputs(params, cfg, tokens=tokens)
    lo, hi = tp.vocab
    t = tokens.to(torch.int64) - lo
    here = (t >= 0) & (t < hi - lo)
    e = params["embed"][torch.clamp(t, 0, hi - lo - 1)]
    x = tp.reduce(torch.where(here[..., None], e, torch.zeros_like(e[:1, :1])), tp.vocab_axes)
    return _scale_embeddings(cfg, x)


def layer_qkv(lp, cfg: ModelConfig, h: Array, positions: Array, theta: float,
              runtime=Runtime()):
    """:func:`qkv` on the rank's query heads and the kv heads they read
    under ``runtime.tensor``, each made whole over ``head_dim`` (one
    all-gather over sp) before ``qk_norm`` and RoPE. The input passes a
    ``copy`` over the attention axes (for the training loss: its gradient
    is the sum of the ranks' shares)."""
    tp = getattr(runtime, "tensor", None)
    if tp is None:
        return qkv(lp, cfg, h, positions, theta)
    u0, u1 = tp.kv_used
    h = tp.copy(h, tp.attn_axes)
    q = _proj(h, lp["wq"])
    k, v = _proj(h, lp["wk"][:, u0:u1]), _proj(h, lp["wv"][:, u0:u1])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"][u0:u1], v + lp["bv"][u0:u1]
    q, k, v = tp.gather_heads(q, k, v)
    if cfg.qk_norm:
        q = rms_norm(q, tp.whole_head_dim(lp["q_norm"], cfg.head_dim), cfg.rms_eps)
        k = rms_norm(k, tp.whole_head_dim(lp["k_norm"], cfg.head_dim), cfg.rms_eps)
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def layer_attn_out(lp, out: Array, runtime=Runtime()) -> Array:
    """:func:`attn_out`; under ``runtime.tensor`` the rank's ``head_dim``
    columns through its row-parallel ``wo`` block, reduced over the
    attention axes."""
    tp = getattr(runtime, "tensor", None)
    if tp is None:
        return attn_out(lp, out)
    return tp.reduce(attn_out(lp, tp.head_dim_block(out)), tp.attn_axes)


def layer_ffn(lp, cfg: ModelConfig, h: Array, runtime=Runtime()) -> Array:
    """The FFN (``_ffn_block``); under ``runtime.tensor`` the gated MLP on
    the rank's columns (its input behind a ``copy``), its row-parallel
    output reduced."""
    tp = getattr(runtime, "tensor", None)
    if tp is None:
        return _ffn_block(lp, cfg, h, runtime)
    h = tp.copy(h, tp.mlp_axes)
    return tp.reduce(gated_mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.act),
                     tp.mlp_axes)


def head_logits(params, cfg: ModelConfig, h: Array, runtime=Runtime()) -> Array:
    """Float32 logits of hidden ``h``: under ``runtime.tensor`` the rank's
    vocabulary block."""
    tp = getattr(runtime, "tensor", None)
    return _head_logits(params, cfg, h, None if tp is None else tp.vocab)


def greedy(logits: Array, runtime=Runtime()) -> Array:
    """(..., V) logits (the rank's vocabulary block under ``runtime.tensor``)
    -> (...) int64 ids of their largest value, the first of a tie."""
    tp = getattr(runtime, "tensor", None)
    if tp is None:
        return torch.argmax(logits, dim=-1)
    return tp.argmax(logits)


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
    return _scale_embeddings(cfg, x)


def _scale_embeddings(cfg: ModelConfig, x: Array) -> Array:
    if cfg.scale_embeddings:
        x = x * torch.full((), cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def _trunk(params, cfg: ModelConfig, tokens, embeds, runtime: Runtime, keep: bool):
    """Embed and run every layer. Returns (normed hidden (B, S, d), the
    layers' (k, v) and, for HYBRID, their final (ssm_state, conv_state):
    lists, empty unless ``keep``). Under ``runtime.sequence`` (DENSE, token
    ids only) the hidden is this rank's span's of the prompt and (k, v)
    the whole prompt's."""
    check_trunk(cfg)
    tp, seq = check_split(cfg, runtime)
    if tp is None and seq is None:
        x = embed_inputs(params, cfg, tokens, embeds)
        lo, hi = 0, x.shape[1]
    else:
        s = tokens.shape[1]
        lo, hi = seq.prompt_span(s) if seq is not None else (0, s)
        x = embed_tokens(params, cfg, tokens[:, lo:hi], runtime)
    positions = torch.arange(lo, hi, dtype=torch.int64, device=x.device)
    kvs, states = [], []
    for i, lp in enumerate(unstacked_layers(params) if tp is None else _tp_layers(params, tp)):
        w_i, th_i = static_layer_meta(cfg, i)
        if cfg.family is Family.HYBRID:
            x, kv, ss, cs = _hybrid_layer(lp, cfg, x, positions, w_i, th_i, runtime)
            if keep:
                states.append((ss, cs))
        else:
            x, kv = _layer_fwd(lp, cfg, x, positions, w_i, th_i, runtime, lo)
        if keep:
            kvs.append(kv)
    return rms_norm(x, params["final_norm"], cfg.rms_eps), kvs, states


def forward_hidden(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                   runtime=Runtime(), return_kv: bool = False):
    """Full-sequence forward. Returns hidden (B,S,d) [, stacked (k, v) of
    shape (L, B, S, Hkv, hd) each]. Under ``runtime.sequence`` the hidden
    is this rank's span's; under ``runtime.tensor`` k and v hold its kv
    heads."""
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
    h = forward_hidden(params, cfg, tokens=tokens, embeds=embeds, runtime=runtime)
    # targets are the next-token predictions of the LAST targets.shape[1]
    # positions
    h = h[:, -targets.shape[1]:]
    tp = getattr(runtime, "tensor", None)  # any object without the field: one device
    if tp is not None:
        return _chunked_ce(params, cfg, tp.copy(h, tp.vocab_axes), targets, loss_mask,
                           ce=_tp_ce(params, cfg, tp))
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


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None,
               runtime=Runtime()):
    """A zeroed cache on the CUDA card unless ``device`` names another: of
    ``batch`` rows, the rank's kv heads under ``runtime.tensor`` and its
    span of ``max_len`` positions under ``runtime.sequence``."""
    tp, seq = check_split(cfg, runtime)
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    device = resolve_device(device)
    lo, hi = seq.cache_span(max_len) if seq is not None else (0, max_len)
    hkv = cfg.num_kv_heads if tp is None else tp.kv_heads
    shape = (cfg.num_layers, batch, hi - lo, hkv, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": 0,
    }
    if seq is not None:
        cache["span"] = (lo, hi)
    if cfg.family is Family.HYBRID:
        cache.update(ssm_states(cfg, batch, device))
    return cache


def prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None, cache_len: int,
            runtime=Runtime()):
    """Run the full prompt: (last-position logits (B,1,V) f32, cache with
    the prompt's KV in rows [0, S) and zeros up to ``cache_len``; HYBRID's
    with every layer's final SSM and conv states). Under
    ``runtime.tensor`` the logits are the rank's vocabulary block and the
    cache holds its kv heads; under ``runtime.sequence`` the cache holds
    its span ``cache["span"]`` of the ``cache_len`` positions."""
    h, kvs, states = _trunk(params, cfg, tokens, embeds, runtime, True)
    k, v = (torch.stack(t) for t in zip(*kvs))
    s = k.shape[2]
    seq = getattr(runtime, "sequence", None)
    lo, hi = seq.cache_span(cache_len) if seq is not None else (0, cache_len)
    if seq is not None:
        k, v = k[:, :, lo:min(hi, s)], v[:, :, lo:min(hi, s)]
    pad = hi - lo - k.shape[2]
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    cache = {"k": k, "v": v, "pos": s}
    if seq is not None:
        cache["span"] = (lo, hi)
    if states:
        cache["ssm_state"], cache["conv_state"] = (torch.stack(t) for t in zip(*states))
    last = h[:, -1:] if seq is None else seq.last(h[:, -1:])
    return head_logits(params, cfg, last, runtime), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, runtime=Runtime()):
    """One-token decode. tokens: (B, 1) int. Writes the new KV into
    ``cache`` in place, advances ``cache["pos"]`` and returns
    (logits (B,1,V) f32, cache). Under ``runtime.sequence`` only the rank
    whose span holds the position writes it, every rank scores its span
    and the partial softmaxes merge over the ranks."""
    check_trunk(cfg)
    _, seq = check_split(cfg, runtime)
    pos = int(cache["pos"])
    x = embed_tokens(params, cfg, tokens, runtime)
    b = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q_pos = torch.full((b,), pos, dtype=torch.int64, device=x.device)
    k_all, v_all = cache["k"], cache["v"]
    lo, hi = cache.get("span", (0, k_all.shape[2]))
    own = seq is None or lo <= pos < hi
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        w_i, th_i = static_layer_meta(cfg, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = layer_qkv(lp, cfg, h, positions, th_i, runtime)
        if own:
            k_all[i, :, pos - lo] = k[:, 0]
            v_all[i, :, pos - lo] = v[:, 0]
        if seq is None:
            out = attention_decode(q, k_all[i], v_all[i], q_pos, w_i)
        else:
            out = seq.merge(*attention_decode_partial(q, k_all[i], v_all[i], q_pos, w_i,
                                                      lo)).to(q.dtype)
        a = layer_attn_out(lp, out, runtime)
        if cfg.family is Family.HYBRID:
            a = 0.5 * (a + hybrid_decode(lp, cfg, x, cache, i))
        x = x + a
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + layer_ffn(lp, cfg, h, runtime)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    cache["pos"] = pos + 1
    return head_logits(params, cfg, x, runtime), cache


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
