"""Encoder-decoder backbone, the ENCDEC family (seamless-m4t-medium; port
of ``repro/models/encdec.py``). The speech/text frontend is a stub, as in
the JAX package: the encoder takes precomputed frame embeddings
(B, S_src, d).

Encoder: bidirectional self-attention blocks. Decoder: causal
self-attention, cross-attention to the encoder's output, gated FFN. The
layers run as a Python loop over the stacked parameters, as in
``models/transformer``. Every attention goes through
``select_attention``, so ``attn_impl="flash"`` sends the encoder's
self-attention, the decoder's and the cross-attention (Sq != Sk,
bidirectional, Sq = 1 at every decode step) to K5; the decoder's
self-attention at decode is the plain ``attention_decode``, as in the
JAX package.

Serving cache: ``{"k", "v": (L, B, S, Hkv, hd), "xk", "xv": (L, B,
S_src, Hkv, hd), "pos": int}``; :func:`decode_step` writes the new KV
into it IN PLACE and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import GLOBAL, Family, ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    attention_decode,
    gated_mlp,
    rms_norm,
    select_attention,
)
from repro_torch.models.params import ParamDecl, init_tree
from repro_torch.models.transformer import (
    _chunked_ce,
    _head_logits,
    _proj,
    attn_out,
    layer_params,
    unstacked_layers,
)

Array = torch.Tensor


def _attn_decls(L, d, H, Hkv, hd, pd, prefix=""):
    return {
        prefix + "wq": ParamDecl((L, d, H, hd), ("layers", "embed", "heads", "head_dim"), "normal", pd),
        prefix + "wk": ParamDecl((L, d, Hkv, hd), ("layers", "embed", "kv", "head_dim"), "normal", pd),
        prefix + "wv": ParamDecl((L, d, Hkv, hd), ("layers", "embed", "kv", "head_dim"), "normal", pd),
        prefix + "wo": ParamDecl((L, H, hd, d), ("layers", "heads", "head_dim", "embed"), "normal_out", pd),
    }


def _ffn_decls(L, d, ff, pd):
    return {
        "w_gate": ParamDecl((L, d, ff), ("layers", "embed", "mlp"), "normal", pd),
        "w_up": ParamDecl((L, d, ff), ("layers", "embed", "mlp"), "normal", pd),
        "w_down": ParamDecl((L, ff, d), ("layers", "mlp", "embed"), "normal_out", pd),
    }


def param_decls(cfg: ModelConfig):
    if cfg.family is not Family.ENCDEC:
        raise ValueError(f"{cfg.name}: family {cfg.family.value} is not ENCDEC")
    d, H, Hkv, hd, ff, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                            cfg.d_ff, cfg.padded_vocab)
    Le, Ld = cfg.num_encoder_layers, cfg.num_layers
    pd = cfg.param_dtype
    enc = {
        "attn_norm": ParamDecl((Le, d), ("layers", "embed"), "zeros", pd),
        "mlp_norm": ParamDecl((Le, d), ("layers", "embed"), "zeros", pd),
        **_attn_decls(Le, d, H, Hkv, hd, pd),
        **_ffn_decls(Le, d, ff, pd),
    }
    dec = {
        "attn_norm": ParamDecl((Ld, d), ("layers", "embed"), "zeros", pd),
        "cross_norm": ParamDecl((Ld, d), ("layers", "embed"), "zeros", pd),
        "mlp_norm": ParamDecl((Ld, d), ("layers", "embed"), "zeros", pd),
        **_attn_decls(Ld, d, H, Hkv, hd, pd),
        **_attn_decls(Ld, d, H, Hkv, hd, pd, prefix="x_"),
        **_ffn_decls(Ld, d, ff, pd),
    }
    return {
        "embed": ParamDecl((V, d), ("vocab", "embed"), "normal", pd),
        "enc_layers": enc,
        "dec_layers": dec,
        "enc_final_norm": ParamDecl((d,), ("embed",), "zeros", pd),
        "final_norm": ParamDecl((d,), ("embed",), "zeros", pd),
        "lm_head": ParamDecl((d, V), ("embed", "vocab"), "normal_out", pd),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator):
    """Random parameters on ``generator``'s device."""
    return init_tree(param_decls(cfg), generator)


def _self_attn(lp, cfg: ModelConfig, x: Array, positions: Array, *, bidirectional: bool):
    """Self-attention on pre-normed x (B, S, d). Returns (out, (k, v))."""
    th = cfg.rope_theta_global
    q = apply_rope(_proj(x, lp["wq"]), positions, th)
    k = apply_rope(_proj(x, lp["wk"]), positions, th)
    v = _proj(x, lp["wv"])
    out = select_attention(cfg.attn_impl, q, k, v, positions, positions, GLOBAL,
                           chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv,
                           bidirectional=bidirectional)
    return attn_out(lp, out), (k, v)


def _cross_attn(lp, cfg: ModelConfig, x: Array, enc_kv) -> Array:
    """Cross-attention: q from the decoder's pre-normed x (B, Sq, d), k / v
    (B, S_src, Hkv, hd) precomputed from the encoder; no RoPE, no mask."""
    k, v = enc_kv
    q = _proj(x, lp["x_wq"])
    sq, sk = x.shape[1], k.shape[1]
    out = select_attention(
        cfg.attn_impl, q, k, v, torch.arange(sq, device=x.device),
        torch.arange(sk, device=x.device), GLOBAL, bidirectional=True,
        chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
    h, hd, d = lp["x_wo"].shape
    return out.flatten(-2) @ lp["x_wo"].reshape(h * hd, d)


def _ffn(lp, cfg: ModelConfig, x: Array) -> Array:
    h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
    return x + gated_mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.act)


def encode(params, cfg: ModelConfig, frames: Array) -> Array:
    """frames: (B, S_src, d) precomputed frontend embeddings -> the
    encoder's normed output (B, S_src, d)."""
    x = frames.to(getattr(torch, cfg.compute_dtype))
    positions = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    for lp in unstacked_layers({"layers": params["enc_layers"]}):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        a, _ = _self_attn(lp, cfg, h, positions, bidirectional=True)
        x = _ffn(lp, cfg, x + a)
    return rms_norm(x, params["enc_final_norm"], cfg.rms_eps)


def _enc_cross_kv(params, cfg: ModelConfig, enc_h: Array):
    """Every decoder layer's cross K / V: (L, B, S_src, Hkv, hd) each."""
    ks, vs = [], []
    for lp in unstacked_layers({"layers": params["dec_layers"]}):
        ks.append(_proj(enc_h, lp["x_wk"]))
        vs.append(_proj(enc_h, lp["x_wv"]))
    return torch.stack(ks), torch.stack(vs)


def _decoder(params, cfg: ModelConfig, tokens: Array, xk: Array, xv: Array):
    """Teacher-forced decoder over tokens (B, S_tgt) against the cross
    K / V. Returns (normed hidden (B, S_tgt, d), the layers' (k, v))."""
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], dtype=torch.int64, device=x.device)
    kvs = []
    for i, lp in enumerate(unstacked_layers({"layers": params["dec_layers"]})):
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        a, kv = _self_attn(lp, cfg, h, positions, bidirectional=False)
        x = x + a
        h = rms_norm(x, lp["cross_norm"], cfg.rms_eps)
        x = _ffn(lp, cfg, x + _cross_attn(lp, cfg, h, (xk[i], xv[i])))
        kvs.append(kv)
    return rms_norm(x, params["final_norm"], cfg.rms_eps), kvs


def decode_train(params, cfg: ModelConfig, tokens: Array, enc_h: Array) -> Array:
    """Teacher-forced decoder pass. tokens: (B, S_tgt). Returns hidden."""
    xk, xv = _enc_cross_kv(params, cfg, enc_h)
    return _decoder(params, cfg, tokens, xk, xv)[0]


def lm_loss(params, cfg: ModelConfig, *, frames, tokens, targets, loss_mask=None,
            runtime=None):
    """Next-token cross-entropy of the decoder over ``targets``. As in
    ``transformer.lm_loss``, a loss asked of ``attn_impl="flash"`` raises:
    K5 has no backward."""
    del runtime
    if cfg.attn_impl == "flash":
        raise NotImplementedError(
            "lm_loss with attn_impl='flash': K5 (flash_attention_fwd) has no "
            "backward in either package; train with attn_impl 'auto' or 'xla'"
        )
    h = decode_train(params, cfg, tokens, encode(params, cfg, frames))
    return _chunked_ce(params, cfg, h, targets, loss_mask)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int, dtype=None,
               device=None):
    """A zeroed cache on the CUDA card unless ``device`` names another."""
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    device = resolve_device(device)
    L, Hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    z = lambda s: torch.zeros((L, batch, s, Hkv, hd), dtype=dtype, device=device)  # noqa: E731
    return {"k": z(max_len), "v": z(max_len), "xk": z(src_len), "xv": z(src_len), "pos": 0}


def prefill(params, cfg: ModelConfig, *, frames, tokens, cache_len: int, runtime=None):
    """Encode the source and teacher-force the target prefix: (last
    position's logits (B, 1, V) f32, cache with the prefix's KV in rows
    [0, S) and zeros up to ``cache_len``, and the cross K / V)."""
    del runtime
    xk, xv = _enc_cross_kv(params, cfg, encode(params, cfg, frames))
    h, kvs = _decoder(params, cfg, tokens, xk, xv)
    k, v = (torch.stack(t) for t in zip(*kvs))
    s = k.shape[2]
    pad = cache_len - s
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    cache = {"k": k, "v": v, "xk": xk, "xv": xv, "pos": s}
    return _head_logits(params, cfg, h[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, runtime=None):
    """One decoder token (B, 1) against the self cache and the cross cache.
    Writes the new KV into ``cache`` in place, advances ``cache["pos"]``
    and returns (logits (B, 1, V) f32, cache)."""
    del runtime
    pos = int(cache["pos"])
    x = params["embed"][tokens]
    b = x.shape[0]
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q_pos = torch.full((b,), pos, dtype=torch.int64, device=x.device)
    th = cfg.rope_theta_global
    for i in range(cfg.num_layers):
        lp = layer_params({"layers": params["dec_layers"]}, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q = apply_rope(_proj(h, lp["wq"]), positions, th)
        k = apply_rope(_proj(h, lp["wk"]), positions, th)
        cache["k"][i, :, pos] = k[:, 0]
        cache["v"][i, :, pos] = _proj(h, lp["wv"])[:, 0]
        out = attention_decode(q, cache["k"][i], cache["v"][i], q_pos, GLOBAL)
        x = x + attn_out(lp, out)
        h = rms_norm(x, lp["cross_norm"], cfg.rms_eps)
        x = _ffn(lp, cfg, x + _cross_attn(lp, cfg, h, (cache["xk"][i], cache["xv"][i])))
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    cache["pos"] = pos + 1
    return _head_logits(params, cfg, x), cache
