"""CUDA wrapper of K1, the fused FedAvg apply (port of
``repro/kernels/fedavg/fedavg.py``).

``fedavg_apply_cuda`` builds the weight row as the JAX wrapper does,
``wn = lr·m·w / (Σ m·w + 1e-12)`` with torch ops on the device (no host
synchronisation), and launches ``fedfog_fedavg_apply`` of the delta
pipeline's library (``delta_pipeline/csrc/delta_pipeline.cu``): K3's
``fedavg_kernel`` with every gate off, so K1 sums over the clients in
K3's order with K3's FMAs and applies ``base + Σ wn_i·Δ_i`` with one
rounding to the output dtype, on the grid and ring of ``delta_pipeline.fedavg_plan``
at the updates' element size. CUDA tensors only: it checks device, dtype
(float32 or bfloat16, one for updates and base), shapes and contiguity,
allocates the output with ``torch.empty``, launches on the current stream
and raises if the launch is refused. ``launch_fedavg.launches`` grows by
one per launch. ``ops.py`` sends CPU tensors to the plain version in
``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.delta_pipeline import delta_pipeline as dp_cuda

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def library():
    """The delta pipeline's library (built on first use) with K1 bound."""
    kl = dp_cuda.library()
    kl.lib.fedfog_fedavg_apply.argtypes = [_P] * 4 + [_I, _LL, _I] + [_I] * 5 + [_P]
    kl.lib.fedfog_fedavg_apply.restype = _I
    return kl


def weight_row(mask: torch.Tensor, weights: torch.Tensor, lr) -> torch.Tensor:
    """(N,) float32 ``lr·m·w / (Σ m·w + 1e-12)``, in the JAX wrapper's
    order of operations."""
    wn = mask.to(torch.float32) * weights.to(torch.float32)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=wn.device)
    return lr * wn / (torch.sum(wn) + 1e-12)


def fedavg_apply_cuda(updates: torch.Tensor, base: torch.Tensor, mask: torch.Tensor,
                      weights: torch.Tensor, lr=1.0) -> torch.Tensor:
    """K1: (N, D) updates, (D,) base, (N,) mask and weights -> the (D,)
    updated base, in base's dtype."""
    if updates.dim() != 2:
        raise ValueError(f"updates must be (N, D), got {tuple(updates.shape)}")
    n, d = updates.shape
    for name, t, shape in (("updates", updates, (n, d)), ("base", base, (d,)),
                           ("mask", mask, (n,)), ("weights", weights, (n,))):
        if t.device.type != "cuda" or t.device != updates.device:
            raise ValueError(f"{name} must be a CUDA tensor on {updates.device}, got {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if updates.dtype not in _DTYPES or base.dtype != updates.dtype:
        raise ValueError(f"updates and base must share float32 or bfloat16, got "
                         f"{updates.dtype} and {base.dtype}")
    if not (updates.is_contiguous() and base.is_contiguous()):
        raise ValueError("updates and base must be contiguous")
    if n > 4096:
        raise ValueError(f"the kernel supports N <= 4096 clients, got {n}")
    out = torch.empty_like(base)
    launch_fedavg(updates, base, weight_row(mask, weights, lr), out)
    return out


def launch_fedavg(updates, base, wn, out):
    """Launch K1 on a prepared (N,) float32 weight row into ``out``. The
    one place K1 is launched, and so the one place its count grows."""
    n, d = updates.shape
    lib = library().lib
    with torch.cuda.device(updates.device):
        stream = torch.cuda.current_stream(updates.device).cuda_stream
        rc = lib.fedfog_fedavg_apply(updates.data_ptr(), base.data_ptr(), wn.data_ptr(),
                                     out.data_ptr(), n, d, _DTYPES[updates.dtype],
                                     *dp_cuda.device_plan(updates).c_args(), stream)
    if rc != 0:
        raise RuntimeError(f"fedavg_apply: launch failed (code {rc})")
    launch_fedavg.launches += 1


launch_fedavg.launches = 0
