"""RWKV6 ("Finch") — attention-free LM with data-dependent decay (port of
``repro/models/rwkv6.py``).

Token-shift mixing with low-rank data-dependent interpolation (time_maa
LoRA), data-dependent per-channel decay ``w = exp(-exp(w0 + lora(x)))``,
per-head WKV state recurrence, gated output and squared-ReLU channel-mix;
RMSNorm where upstream uses LayerNorm with bias, as in the JAX package.
Head layout: heads = d_model // 64 (hd = 64).

Parameters keep the JAX package's stacked layout (leading ``num_layers``
dim), so one tree serves both packages through ``convert``. The layers
run as a Python loop. The WKV recurrence takes one of two routes, chosen
by the arguments: with no state (prefill) it goes through
``kernels.wkv6.ops.wkv6`` — K6 on a CUDA tensor, its plain version on a
CPU one — and with a state (decode, T = 1) through the plain step of
``models.ssm``, as the JAX package's ``decode_step`` does.

Serving: :func:`prefill` returns the last position's logits and the O(1)
recurrent state ``{"wkv": (L, B, H, 64, 64) f32, "tm_x", "cm_x": (L, B,
d), "pos": int}``; :func:`decode_step` advances it one token, writing
the state IN PLACE (its caller owns it) and returning it.

Training: :func:`lm_loss` runs the recurrence from zero through the
plain step of ``models.ssm`` (differentiable, no clamp on w, as the JAX
model's loss runs it), since K6 is forward-only in both packages.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamDecl, init_tree
from repro_torch.models.transformer import _chunked_ce, _head_logits, unstacked_layers

Array = torch.Tensor

HEAD_DIM = 64
MAA_RANK = 32
DECAY_RANK = 64
N_MAA = 5  # w, k, v, r, g


def num_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


def param_decls(cfg: ModelConfig):
    if cfg.family is not Family.SSM:
        raise ValueError(f"{cfg.name}: rwkv6 declares the SSM family only")
    L, d, ff, V = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    H = num_heads(cfg)
    pd = cfg.param_dtype
    layers = {
        "ln_tm": ParamDecl((L, d), ("layers", "embed"), "zeros", pd),
        "ln_cm": ParamDecl((L, d), ("layers", "embed"), "zeros", pd),
        # token-shift interpolation vectors + LoRA
        "maa_x": ParamDecl((L, d), ("layers", "embed"), "zeros", pd),
        "maa_wkvrg": ParamDecl((L, N_MAA, d), ("layers", None, "embed"), "zeros", pd),
        "maa_w1": ParamDecl((L, d, N_MAA * MAA_RANK), ("layers", "embed", None), "normal", pd),
        "maa_w2": ParamDecl((L, N_MAA, MAA_RANK, d), ("layers", None, None, "embed"), "normal", pd),
        # decay
        "decay": ParamDecl((L, d), ("layers", "mlp"), "zeros", "float32"),
        "decay_w1": ParamDecl((L, d, DECAY_RANK), ("layers", "embed", None), "normal", pd),
        "decay_w2": ParamDecl((L, DECAY_RANK, d), ("layers", None, "mlp"), "normal", pd),
        "u": ParamDecl((L, H, HEAD_DIM), ("layers", "heads", "head_dim"), "zeros", "float32"),
        # projections
        "wr": ParamDecl((L, d, d), ("layers", "embed", "mlp"), "normal", pd),
        "wk": ParamDecl((L, d, d), ("layers", "embed", "mlp"), "normal", pd),
        "wv": ParamDecl((L, d, d), ("layers", "embed", "mlp"), "normal", pd),
        "wg": ParamDecl((L, d, d), ("layers", "embed", "mlp"), "normal", pd),
        "wo": ParamDecl((L, d, d), ("layers", "mlp", "embed"), "normal_out", pd),
        "ln_x": ParamDecl((L, d), ("layers", "mlp"), "zeros", pd),
        # channel-mix
        "cm_maa_k": ParamDecl((L, d), ("layers", "embed"), "zeros", pd),
        "cm_maa_r": ParamDecl((L, d), ("layers", "embed"), "zeros", pd),
        "cm_wk": ParamDecl((L, d, ff), ("layers", "embed", "mlp"), "normal", pd),
        "cm_wv": ParamDecl((L, ff, d), ("layers", "mlp", "embed"), "normal_out", pd),
        "cm_wr": ParamDecl((L, d, d), ("layers", "embed", None), "normal", pd),
    }
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


def layer_params(params, i: int) -> dict[str, Array]:
    """Layer i's slice of the stacked parameters (views)."""
    return {k: v[i] for k, v in params["layers"].items()}


def _shift(x: Array, prev: Array | None = None) -> Array:
    """Token shift: x_{t-1} along time; the first step takes ``prev``
    (decode) or zeros."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _data_dependent_mix(lp, x: Array, xprev: Array):
    """Finch token-shift: five interpolated views of (x, x_{t-1})."""
    dx = xprev - x
    xxx = x + dx * lp["maa_x"]
    r1 = torch.tanh(xxx @ lp["maa_w1"])  # (B, T, 5*rank)
    b, t, _ = r1.shape
    r1 = r1.reshape(b, t, N_MAA, MAA_RANK)
    mods = torch.einsum("btnr,nrd->btnd", r1, lp["maa_w2"])  # (B, T, 5, d)
    return [x + dx * (lp["maa_wkvrg"][i] + mods[:, :, i]) for i in range(N_MAA)]


def _time_mix(lp, cfg: ModelConfig, x: Array, wkv_state=None, x_prev=None,
              plain: bool = False):
    """Returns (out, new_wkv_state, last_x). x: (B, T, d). No state: the
    recurrence from zero through K6 (``kernels.wkv6.ops``), or with
    ``plain`` through the plain step (training); a state: the plain
    recurrence from it (``models.ssm.wkv6``)."""
    b, t, d = x.shape
    H = num_heads(cfg)
    xprev = _shift(x, x_prev)
    xw, xk, xv, xr, xg = _data_dependent_mix(lp, x, xprev)
    r = xr @ lp["wr"]
    k = xk @ lp["wk"]
    v = xv @ lp["wv"]
    g = torch.nn.functional.silu(xg @ lp["wg"])
    ww = lp["decay"].to(torch.float32) + (
        torch.tanh(xw @ lp["decay_w1"]) @ lp["decay_w2"]
    ).to(torch.float32)
    # (B, T, d) in (0, 1), cast to the compute dtype before the recurrence
    # as the JAX model does
    w = torch.exp(-torch.exp(ww)).to(x.dtype)

    def heads(z):
        return z.reshape(b, t, H, HEAD_DIM)

    if wkv_state is None and not plain:
        y, s_final = wkv6_ops.wkv6(heads(r), heads(k), heads(v), heads(w), lp["u"])
    else:
        y, s_final = ssm_mod.wkv6(heads(r), heads(k), heads(v), heads(w), lp["u"],
                                  initial_state=wkv_state)
    y = y.reshape(b, t, d)
    y = rms_norm(y, lp["ln_x"], cfg.rms_eps) * g
    return y @ lp["wo"], s_final, x[:, -1]


def _channel_mix(lp, x: Array, x_prev=None):
    xprev = _shift(x, x_prev)
    dx = xprev - x
    xk = x + dx * lp["cm_maa_k"]
    xr = x + dx * lp["cm_maa_r"]
    k = torch.square(torch.relu(xk @ lp["cm_wk"]))
    kv = k @ lp["cm_wv"]
    return torch.sigmoid(xr @ lp["cm_wr"]) * kv, x[:, -1]


def _layer(lp, x: Array, cfg: ModelConfig, state=None, plain: bool = False):
    """One RWKV block. state: dict with wkv / tm_x / cm_x, or None
    (prefill from zero; ``plain`` for training)."""
    h = rms_norm(x, lp["ln_tm"], cfg.rms_eps)
    tm_out, wkv_new, tm_x = _time_mix(
        lp, cfg, h,
        None if state is None else state["wkv"],
        None if state is None else state["tm_x"],
        plain,
    )
    x = x + tm_out
    h = rms_norm(x, lp["ln_cm"], cfg.rms_eps)
    cm_out, cm_x = _channel_mix(lp, h, None if state is None else state["cm_x"])
    return x + cm_out, {"wkv": wkv_new, "tm_x": tm_x, "cm_x": cm_x}


def forward_hidden(params, cfg: ModelConfig, *, tokens=None, embeds=None,
                   runtime=None, return_state: bool = False, plain: bool = False):
    """Full-sequence forward from a zero state. Returns hidden (B, S, d)
    [, the stacked per-layer final states]. ``plain`` runs the recurrence
    step by step instead of through K6 (the training loss)."""
    del runtime
    x = params["embed"][tokens] if tokens is not None else embeds
    states = []
    for lp in unstacked_layers(params):
        x, st = _layer(lp, x, cfg, plain=plain)
        if return_state:
            states.append(st)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if not return_state:
        return x
    return x, {key: torch.stack([st[key] for st in states]) for key in states[0]}


def lm_loss(params, cfg: ModelConfig, *, tokens=None, embeds=None, targets,
            loss_mask=None, runtime=None):
    """Next-token cross-entropy (``transformer._chunked_ce``) over the
    plain recurrence."""
    h = forward_hidden(params, cfg, tokens=tokens, embeds=embeds, plain=True)
    h = h[:, -targets.shape[1]:]
    return _chunked_ce(params, cfg, h, targets, loss_mask)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None):
    """A zeroed recurrent state on the CUDA card unless ``device`` names
    another. Its size does not depend on ``max_len``."""
    del max_len, dtype  # O(1) state: the point of the family
    device = resolve_device(device)
    L, d = cfg.num_layers, cfg.d_model
    H = num_heads(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    return {
        "wkv": torch.zeros((L, batch, H, HEAD_DIM, HEAD_DIM), dtype=torch.float32,
                           device=device),
        "tm_x": torch.zeros((L, batch, d), dtype=cdt, device=device),
        "cm_x": torch.zeros((L, batch, d), dtype=cdt, device=device),
        "pos": 0,
    }


def prefill(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            cache_len: int = 0, runtime=None):
    """Run the full prompt: (last-position logits (B, 1, V) f32, state)."""
    del cache_len, runtime
    h, states = forward_hidden(params, cfg, tokens=tokens, embeds=embeds,
                               return_state=True)
    cache = dict(states, pos=(tokens if tokens is not None else embeds).shape[1])
    return _head_logits(params, cfg, h[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, cache, tokens, runtime=None):
    """tokens: (B, 1). Writes each layer's new state into ``cache`` in
    place, advances ``cache["pos"]`` and returns (logits (B, 1, V) f32,
    cache)."""
    del runtime
    x = params["embed"][tokens]
    for i in range(cfg.num_layers):
        st = {key: cache[key][i] for key in ("wkv", "tm_x", "cm_x")}
        x, st_new = _layer(layer_params(params, i), x, cfg, state=st)
        for key in ("wkv", "tm_x", "cm_x"):
            cache[key][i] = st_new[key]
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    cache["pos"] = int(cache["pos"]) + 1
    return _head_logits(params, cfg, x), cache
