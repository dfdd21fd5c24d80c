"""State-space recurrences in plain PyTorch (port of
``repro/models/ssm.py``): the Mamba-style ``selective_scan`` of the
HYBRID family (hymba's SSM heads) and ``selective_scan_step`` for one
decode token; RWKV6's ``wkv6`` over a sequence from an optional initial
state, and ``wkv6_step`` for one decode token, both K6's plain version
(``kernels/wkv6/ref.py``).

The JAX package scans both recurrences in checkpointed chunks (``chunk``
bounds what autodiff saves); the port runs no backward through them for
serving, so they take no chunk and run step by step in float32. The
hand-written kernel of the RWKV6 recurrence from a zero state is K6;
``models/rwkv6`` sends its prefill there. ``selective_scan`` has no
Pallas kernel in the JAX package, and so none here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.ref import wkv6_ref, wkv6_step

Array = torch.Tensor

__all__ = ["selective_scan", "selective_scan_step", "wkv6", "wkv6_step"]


def selective_scan(x: Array, dt: Array, a_log: Array, b: Array, c: Array,
                   d_skip: Array, initial_state: Array | None = None):
    """Returns (y (B, T, di) in x's dtype, final_state (B, di, st) float32).

    x, dt: (B, T, di); a_log: (di, st), the log of -A; b, c: (B, T, st);
    d_skip: (di,). Recurrence per channel i, state j, from
    ``initial_state`` (zero if None):

        s_t = exp(-exp(a_log)·dt_t) · s_{t-1} + dt_t · b_t · x_t
        y_t = Σ_j c_t[j] · s_t[:, j] + D · x_t
    """
    bsz, t, di = x.shape
    neg_a = -torch.exp(a_log.float())  # (di, st)
    s = (torch.zeros((bsz, di, a_log.shape[-1]), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    x32, dt32, b32, c32 = x.float(), dt.float(), b.float(), c.float()
    # every step's decay and input at once; the loop carries the state,
    # one fused multiply-add a step, and the readout of every step's state
    # is one product after it
    da = torch.exp(dt32[..., None] * neg_a)  # (B, T, di, st)
    dbx = (dt32 * x32)[..., None] * b32[:, :, None, :]
    states = []
    for i in range(t):
        s = torch.addcmul(dbx[:, i], da[:, i], s)
        states.append(s)
    if states:
        y = torch.einsum("btis,bts->bti", torch.stack(states, dim=1), c32)
    else:
        y = x32.new_zeros((bsz, 0, di))
    y = y + d_skip.float() * x32
    return y.to(x.dtype), s


def selective_scan_step(x_t: Array, dt_t: Array, a_log: Array, b_t: Array, c_t: Array,
                        d_skip: Array, state: Array):
    """One decode step. x_t, dt_t: (B, di); b_t, c_t: (B, st); state
    (B, di, st). Returns (y (B, di) in x_t's dtype, new_state float32)."""
    neg_a = -torch.exp(a_log.float())
    dt32 = dt_t.float()
    da = torch.exp(dt32[..., None] * neg_a)
    dbx = (dt32 * x_t.float())[..., None] * b_t.float()[:, None, :]
    s_new = da * state.float() + dbx
    y = torch.einsum("bis,bs->bi", s_new, c_t.float()) + d_skip.float() * x_t.float()
    return y.to(x_t.dtype), s_new


def wkv6(r: Array, k: Array, v: Array, w: Array, u: Array,
         initial_state: Array | None = None):
    """Returns (y (B, T, H, V), final_state (B, H, K, V) float32).

        y_t = r_t · (S_{t-1} + u ⊙ k_t ⊗ v_t)
        S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t

    The step-by-step recurrence of K6's plain version, from
    ``initial_state`` (zero if None)."""
    return wkv6_ref(r, k, v, w, u, initial_state)
