"""CUDA wrapper of K5, the flash-attention forward (port of
``repro/kernels/flash_attention/flash_attention.py``).

``flash_attention_cuda`` launches the kernel of ``csrc/flash_attention.cu``
on CUDA tensors only: it checks device, dtype, shapes and the contiguous
head_dim, allocates the output with ``torch.empty``, launches on the
current stream and raises if the launch is refused. The dtype picks one
of the source's two kernels, both held against the plain version:
bfloat16 goes to the tensor-core kernel, which copies K and V in 16-byte
pieces (so its rows must be 16-byte aligned, checked here), float32 to
the CUDA-core kernel, since bf16 tensor cores would not keep float32
inputs to float32's tolerance. It takes the model's layout (B, S, H, hd)
and reads it through strides, so any view with a contiguous head_dim
goes in without a copy: the Pallas kernel's (B, H, S, hd) tensors as
``x.transpose(1, 2)``.
``flash_attention_cuda.launches`` grows by one per launch.
``ops.py`` sends CPU tensors to the plain version in ``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
LIBRARY = "fedfog_flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def library():
    """Build (first use) and load the kernel; returns the KernelLibrary."""
    kl = load_library(LIBRARY, [SOURCE])
    kl.lib.fedfog_flash_attention_fwd.argtypes = [_P] * 4 + [_I] * 7 + [_LL] * 12 + [_I, _I, _P]
    kl.lib.fedfog_flash_attention_fwd.restype = _I
    return kl


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         window: int = 0, bidirectional: bool = False) -> torch.Tensor:
    """K5. q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd), any strides with a
    contiguous head_dim; ``window`` in the kernel convention (0 = global).
    Returns a contiguous (B, Sq, H, hd) tensor in q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be 4-d with a contiguous head_dim")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype}, got {t.dtype}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    b, sq, h, hd = q.shape
    bk, sk, hkv, hdk = k.shape
    if bk != b or hdk != hd or k.shape != v.shape or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"{name}: the bfloat16 kernel needs 16-byte aligned rows "
                                 f"(got strides {t.stride()})")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = [(t.stride(0), t.stride(2), t.stride(1)) for t in (q, k, v, out)]  # b, h, s
    lib = library().lib
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fedfog_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
            b, h, hkv, sq, sk, hd, *(x for st in strides for x in st), int(window),
            int(bidirectional), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention: launch failed (code {rc})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
