"""CPU emulation, in torch float32, of the arithmetic of K6's CUDA kernel
(``src/repro_torch/kernels/wkv6/csrc/wkv6.cu``): the chunk-parallel RWKV6
recurrence whose decay factors are all running products of clamped
w <= 1. It is a test helper, never a route of the port.

Per window of ``TW`` steps, with T padded to a multiple of the chunk C by
w = 1 and r = k = v = 0 (which leaves y[:T] and the state unchanged):

  A. for every chunk [c0, c0 + C) at once:
       a_t = prod_{c0<=m<t} w_m        (running product forward, a_{c0} = 1)
       e_s = prod_{s<m<c0+C} w_m       (running product backward)
       g   = a_{c0+C-1} * w_{c0+C-1}
       score[t, s] = sum_k r_t k_s D_{t,s},  D_{s+1,s} = 1, D_{t+1,s} = D_{t,s} w_t
       score[s, s] = sum_k r_s u k_s    (the bonus)
       U = sum_s (k_s * e_s)^T v_s
  B. the carry over chunks: S_in[c] = S; S = g_c * S + U_c;
  C. y_t = sum_{s<=t} score[t, s] v_s + (r_t * a_t) . S_in[c].

Nothing is divided and nothing is exponentiated, so nothing overflows; a
factor that underflows is one whose true value is below float32's range.
"""
from __future__ import annotations

import torch

TW = 128  # steps staged per window in the kernel


def _phase_a(r, k, w, v, u, chunk):
    """r, k, w: (B, H, NC, C, K) float32; v: (B, H, NC, C, V); u: (H, K).
    Returns (ra, g, scores (B, H, NC, C, C) with [t, s] = score of (t, s),
    U (B, H, NC, K, V))."""
    c = chunk
    # running products forward (a_t, then r * a) and backward (e_s)
    a = torch.ones_like(w[..., 0, :])
    ra = torch.empty_like(r)
    for t in range(c):
        ra[..., t, :] = r[..., t, :] * a
        a = a * w[..., t, :]
    g = a
    e = torch.ones_like(a)
    ke = torch.empty_like(k)
    for s in range(c - 1, -1, -1):
        ke[..., s, :] = k[..., s, :] * e
        e = e * w[..., s, :]
    # the scores: for each s, kq = k_s D_{t,s} carried along t
    scores = torch.zeros(r.shape[:-2] + (c, c), dtype=torch.float32)
    for s in range(c):
        scores[..., s, s] = (r[..., s, :] * u[None, :, None, :] * k[..., s, :]).sum(-1)
        kq = k[..., s, :]
        for t in range(s + 1, c):
            scores[..., t, s] = (r[..., t, :] * kq).sum(-1)
            kq = kq * w[..., t, :]
    big_u = torch.einsum("bhnsk,bhnsv->bhnkv", ke, v)
    return ra, g, scores, big_u


def wkv6_chunked(r, k, v, w, u, *, chunk: int = 16, w_min: float = 0.0):
    """r/k/w: (B, T, H, K), v: (B, T, H, V), u: (H, K), any float dtype.
    Returns (y (B, T, H, V) in r's dtype, final state (B, H, K, V) float32),
    from a zero state, w clamped to ``w_min`` as it is read."""
    b, t_len, h, dk = r.shape
    dv = v.shape[-1]
    assert TW % chunk == 0
    f = [x.to(torch.float32).permute(0, 2, 1, 3) for x in (r, k, v, w)]  # (B, H, T, ·)
    r32, k32, v32, w32 = f
    w32 = w32.clamp(min=w_min)
    u32 = u.to(torch.float32)
    s = torch.zeros((b, h, dk, dv), dtype=torch.float32)
    ys = []
    for t0 in range(0, t_len, TW):
        n = min(TW, t_len - t0)
        nc = -(-n // chunk)
        pad = nc * chunk - n

        def window(x, fill):
            x = x[:, :, t0:t0 + n]
            if pad:
                x = torch.cat([x, torch.full(x.shape[:2] + (pad,) + x.shape[3:], fill)], 2)
            return x.reshape(b, h, nc, chunk, x.shape[-1])

        rw, kw, vw, ww = window(r32, 0.0), window(k32, 0.0), window(v32, 0.0), window(w32, 1.0)
        ra, g, scores, big_u = _phase_a(rw, kw, ww, vw, u32, chunk)
        s_in = []
        for c in range(nc):  # phase B
            s_in.append(s)
            s = g[:, :, c, :, None] * s + big_u[:, :, c]
        s_in = torch.stack(s_in, dim=2)  # (B, H, NC, K, V)
        y = scores @ vw + ra @ s_in  # phase C
        ys.append(y.reshape(b, h, nc * chunk, dv)[:, :, :n])
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)
    return y.to(r.dtype), s
