"""CUDA wrapper of K6, the RWKV6 recurrence (port of
``repro/kernels/wkv6/wkv6.py``).

``wkv6_cuda`` launches the kernel of ``csrc/wkv6.cu`` on CUDA tensors
only: it checks device, dtype (float32 or bfloat16, one for r, k, v and
w), shapes (K = V = 64) and the contiguous last dim, allocates y and the
final state with ``torch.empty``, launches on the current stream and
raises if the launch is refused. It reads (B, T, H, K) tensors through
their strides, so views of the model's projections go in without a copy.
``wkv6_cuda.launches`` grows by one per launch. ``ops.py`` sends CPU
tensors to the plain version in ``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"
LIBRARY = "fedfog_wkv6"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


@functools.cache
def library():
    """Build (first use) and load the kernel; returns the KernelLibrary."""
    kl = load_library(LIBRARY, [SOURCE])
    kl.lib.fedfog_wkv6_fwd.argtypes = [_P] * 7 + [_I] * 6 + [_LL] * 12 + [_F, _P]
    kl.lib.fedfog_wkv6_fwd.restype = _I
    return kl


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, *, w_min: float = 0.0):
    """K6 from a zero state. r/k/w (B, T, H, 64), v (B, T, H, 64), u
    (H, 64); w is clamped to ``w_min`` as it is read. Returns (y, a
    contiguous (B, T, H, 64) tensor in r's dtype; the final state, a
    contiguous (B, H, 64, 64) float32 tensor)."""
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"{name} must be a CUDA tensor on {r.device}, got {t.device}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-d with a contiguous last dim")
        if t.dtype != r.dtype:
            raise ValueError(f"{name} must be {r.dtype}, got {t.dtype}")
    if r.dtype not in _DTYPES:
        raise ValueError(f"dtype {r.dtype} not supported (float32, bfloat16)")
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or tuple(v.shape[:3]) != (b, t, h):
        raise ValueError(f"r {tuple(r.shape)}, k, v {tuple(v.shape)} and w do not match")
    if dk != HEAD_DIM or dv != HEAD_DIM:
        raise ValueError(f"head sizes K={dk}, V={dv}: the kernel takes K = V = {HEAD_DIM}")
    if t < 1:
        raise ValueError("T must be at least 1")
    if tuple(u.shape) != (h, dk) or u.device != r.device:
        raise ValueError(f"u must be ({h}, {dk}) on {r.device}, got {tuple(u.shape)}")
    u32 = u.to(torch.float32).contiguous()
    y = torch.empty((b, t, h, dv), dtype=r.dtype, device=r.device)
    s = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    strides = [x.stride(i) for x in (r, k, v, w) for i in range(3)]  # b, t, h
    lib = library().lib
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.fedfog_wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u32.data_ptr(),
            y.data_ptr(), s.data_ptr(), _DTYPES[r.dtype], b, t, h, dk, dv, *strides,
            float(w_min), stream,
        )
    if rc != 0:
        raise RuntimeError(f"wkv6: launch failed (code {rc})")
    wkv6_cuda.launches += 1
    return y, s


wkv6_cuda.launches = 0
