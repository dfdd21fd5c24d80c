"""Shared model building blocks (port of ``repro/models/layers.py``):
norms, RoPE, masking and attention, on torch tensors in the JAX package's
layouts ((B, S, H, hd) activations).

Attention implementations, chosen by ``ModelConfig.attn_impl`` through
:func:`select_attention`:

  * ``"xla"`` / ``"auto"`` — materialised-score attention in plain torch
    (the JAX package leaves these to XLA; the port to PyTorch's ops);
  * ``"flash"`` — K5, the hand-written flash-attention kernel
    (``kernels/flash_attention``), or its plain version on the CPU;
  * ``"xla_chunked"`` — the online-softmax (flash) algorithm in plain
    torch over q and kv chunks (the JAX package's ``jnp`` version), which
    ``"auto"`` picks past 8,192 keys.

All share the mask convention: causal + optional sliding window, where
``window == GLOBAL (-1)`` means unbounded.

The sequence split of static serving (``dist.tensor_parallel.
SequenceParallel``) adds two pieces: :func:`span_attention`, a span of
the prompt's queries against the whole prompt's keys (any
implementation, K5 included: the span's queries sit at the tail of the
keys up to its end), and :func:`attention_decode_partial` /
:func:`merge_attention_partials`, one rank's decode attention over its
span of the cache and the merge of the ranks' partial softmaxes.
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


def attention_xla_chunked(
    q: Array, k: Array, v: Array, q_positions: Array, k_positions: Array,
    window, *, chunk_q: int = 512, chunk_kv: int = 1024, bidirectional: bool = False,
) -> Array:
    """Online-softmax (flash-algorithm) attention in plain torch.

    Two levels: a loop over q chunks and, inside, over kv chunks carrying
    (m, l, acc) in float32, so live memory is O(chunk_q·chunk_kv) scores
    instead of O(Sq·Sk). Ragged q and kv are padded to whole chunks (kv
    padding at position int32-max, masked by causality; q padding at -1,
    cut off). A Python-int window > 0 takes the static-window path: a q
    chunk sees a fixed number of kv chunks from a computed offset. A
    window given as a tensor scans every kv chunk under the mask."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    scale = hd**-0.5
    chunk_q = max(1, min(chunk_q, sq))
    chunk_kv = max(1, min(chunk_kv, sk))

    n_kv = -(-sk // chunk_kv)
    pad_kv = n_kv * chunk_kv - sk
    if pad_kv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad_kv), value=2**31 - 1)
    kc = k.reshape(b, n_kv, chunk_kv, hkv, hd)
    vc = v.reshape(b, n_kv, chunk_kv, hkv, hd)
    kpos_c = k_positions.reshape(n_kv, chunk_kv)

    n_q = -(-sq // chunk_q)
    pad_q = n_q * chunk_q - sq
    qp, q_pos_p = q, q_positions
    if pad_q:
        qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos_p = torch.nn.functional.pad(q_positions, (0, pad_q), value=-1)

    static_window = isinstance(window, int) and window > 0
    kw = min(n_kv, (window + chunk_q - 2) // chunk_kv + 2) if static_window else n_kv
    outs = []
    for qi in range(n_q):
        q_c = qp[:, qi * chunk_q:(qi + 1) * chunk_q]
        qp_c = q_pos_p[qi * chunk_q:(qi + 1) * chunk_q]
        q32 = (q_c * scale).to(q_c.dtype)
        lo = 0
        if static_window:
            first_q = (sk - sq) + qi * chunk_q
            lo = min(max((first_q - window + 1) // chunk_kv, 0), n_kv - kw)
        m = torch.full((b, h, chunk_q), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, chunk_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, chunk_q, hd), dtype=torch.float32, device=q.device)
        for j in range(lo, lo + kw):
            k_c = _repeat_kv(kc[:, j], groups)
            v_c = _repeat_kv(vc[:, j], groups)
            kp_c = kpos_c[j]
            s = torch.einsum("bqhd,bkhd->bhqk", q32, k_c).float()
            if bidirectional:
                zero = torch.zeros((), dtype=torch.float32, device=q.device)
                bias = torch.where(kp_c >= 0, zero, torch.full_like(zero, _NEG_INF))
                s = s + bias[None, None, None]
            else:
                s = s + causal_window_bias(qp_c, kp_c, window)[None, None]
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            # m kept finite on fully-masked rows so exp() yields 0, not NaN
            m_safe = torch.where(m_new <= _NEG_INF / 2, 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.where(m <= _NEG_INF / 2, _NEG_INF, m) - m_safe)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v_c.dtype), v_c).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q_c.dtype))  # (b, cq, h, hd)
    return torch.cat(outs, dim=1)[:, :sq]


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


def attention_decode_partial(
    q: Array, k_span: Array, v_span: Array, q_position: Array, window: int, k_lo: int = 0,
) -> tuple[Array, Array, Array]:
    """:func:`attention_decode` over one span of the cache, unnormalised.

    q: (B, 1, H, hd); k/v_span: (B, s, Hkv, hd), the cache positions
    [k_lo, k_lo + s); q_position: (B,) int. Returns float32 (m (B, H, 1),
    l (B, H, 1), o (B, 1, H, hd)): the largest visible score, the sum of
    exp(score − m) and the exp-weighted sum of v. A span with no visible
    key (past the position, outside the window, or empty) gives m = −inf,
    l = 0 and o = 0, without NaN."""
    b, s, hkv, hd = k_span.shape
    groups = q.shape[2] // hkv
    k = _repeat_kv(k_span, groups)
    v = _repeat_kv(v_span, groups)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * hd**-0.5
    kpos = torch.arange(k_lo, k_lo + s, dtype=torch.int64, device=q.device)
    dq = q_position.to(torch.int64)[:, None]
    visible = kpos[None, :] <= dq
    if int(window) != GLOBAL:
        visible = visible & ((dq - kpos[None, :]) < max(int(window), 1))
    scores = scores.masked_fill(~visible[:, None, None, :], float("-inf"))
    m = torch.amax(scores, dim=-1) if s else torch.full(
        scores.shape[:-1], float("-inf"), device=q.device)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m_safe[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m, torch.sum(p, dim=-1), o


def merge_attention_partials(m: Array, l: Array, o: Array, reduce_max, reduce_sum) -> Array:
    """The softmax attention of the union of the spans whose partials
    (:func:`attention_decode_partial`) each rank holds: ``reduce_max`` and
    ``reduce_sum`` reduce a tensor over the ranks (in place or not). The
    rank's sums and output are rescaled to the global max and summed in
    one reduction. Returns (B, 1, H, hd) float32."""
    mg = reduce_max(m.clone())
    mg = torch.where(torch.isfinite(mg), mg, torch.zeros_like(mg))
    scale = torch.exp(m - mg)  # a span with m = -inf weighs 0
    b, h = l.shape[:2]
    pack = torch.cat([(l * scale).reshape(b, h, 1),
                      (o * scale.transpose(1, 2)[..., None]).reshape(b, h, -1)], dim=-1)
    pack = reduce_sum(pack.contiguous())
    out = pack[..., 1:] / pack[..., :1]
    return out.reshape(b, 1, h, -1)


def span_attention(
    impl: str, q: Array, k: Array, v: Array, lo: int, window: int, *,
    chunk_q: int = 512, chunk_kv: int = 1024,
) -> Array:
    """Causal attention of a span of the prompt's queries, q (B, s, H, hd)
    at positions [lo, lo + s), against the whole prompt's k / v (B, S,
    Hkv, hd): the keys past the span's end are never visible, so the
    span's queries attend to k[:, :lo + s] and sit at its tail, the
    layout K5 reads. ``impl`` as in :func:`select_attention`."""
    hi = lo + q.shape[1]
    kp = torch.arange(hi, dtype=torch.int64, device=q.device)
    return select_attention(impl, q, k[:, :hi], v[:, :hi], kp[lo:], kp, window,
                            chunk_q=chunk_q, chunk_kv=chunk_kv)


def select_attention(
    impl: str, q: Array, k: Array, v: Array, q_positions: Array,
    k_positions: Array, window: int, *, chunk_q: int = 512, chunk_kv: int = 1024,
    bidirectional: bool = False,
) -> Array:
    """Dispatch on attn_impl; "auto" = xla up to 8,192 keys, chunked past.
    ``window`` is a Python int: the layers run as a Python loop, so it
    reaches the kernel (and the chunked path's static-window route) as
    one."""
    if impl == "auto":
        impl = "xla" if k.shape[1] <= 8192 else "xla_chunked"
    if impl == "xla":
        return attention_xla(
            q, k, v, q_positions, k_positions, window, bidirectional=bidirectional
        )
    if impl == "xla_chunked":
        return attention_xla_chunked(
            q, k, v, q_positions, k_positions, window, chunk_q=chunk_q,
            chunk_kv=chunk_kv, bidirectional=bidirectional,
        )
    if impl == "flash":
        from repro_torch.kernels.flash_attention import ops as flash_ops

        return flash_ops.flash_attention(
            q, k, v, q_positions, k_positions, window, bidirectional=bidirectional
        )
    raise ValueError(f"unknown attn impl {impl}")
