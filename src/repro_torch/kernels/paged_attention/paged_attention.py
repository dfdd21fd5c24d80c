"""CUDA wrapper of K7, paged decode attention (port of
``repro/kernels/paged_attention/paged_attention.py``).

``paged_attention_cuda`` launches the kernel of ``csrc/paged_attention.cu``
on CUDA tensors only: it checks device, dtype (float32 or bfloat16 for
q and the pools, int32 for the table and lengths), shapes, contiguity
and the pools' 16-byte alignment, picks the split plan (``split_plan``,
from the table's width alone), allocates the output with ``torch.empty``,
launches one cluster of ``splits`` blocks per (slot, kv head) on the
current stream and raises if the launch is refused.
``paged_attention_cuda.launches`` grows by one per launch. ``ops.py``
sends CPU tensors to the plain version in ``ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels._build import load_library

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
LIBRARY = "fedfog_paged_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_PAGE = 32  # one lane per key of a page
MAX_SPLITS = 8  # the portable cluster size
_P, _I = ctypes.c_void_p, ctypes.c_int


def split_plan(n_pages: int) -> tuple[int, int]:
    """(splits, pages per split) for a table of ``n_pages`` columns: the
    fewest pages per block that fit the slot in one cluster of at most
    ``MAX_SPLITS`` blocks, and no block without a page (10 pages -> 5
    blocks of 2). Takes the table's width, a Python int, never a tensor:
    the decode step must not wait for the device to learn a slot's
    length."""
    if type(n_pages) is not int or n_pages < 1:
        raise TypeError(f"n_pages must be a positive Python int, got {n_pages!r}")
    pps = -(-n_pages // MAX_SPLITS)
    return -(-n_pages // pps), pps


@functools.cache
def library():
    """Build (first use) and load the kernel; returns the KernelLibrary."""
    kl = load_library(LIBRARY, [SOURCE])
    kl.lib.fedfog_paged_attention_fwd.argtypes = [_P] * 6 + [_I] * 10 + [_P]
    kl.lib.fedfog_paged_attention_fwd.restype = _I
    return kl


def _check(t: torch.Tensor, name: str, dev: torch.device, dtypes):
    if t.device != dev:
        raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                         page_table: torch.Tensor, lengths: torch.Tensor, *,
                         window: int = 0) -> torch.Tensor:
    """K7. q (S, H, hd); pools (P, page, Hkv, hd); page_table (S, n_pages)
    and lengths (S,) int32; ``window`` in the kernel convention (0 =
    unbounded). Returns (S, H, hd) in q's dtype; empty slots are zeros."""
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    dev = q.device
    _check(q, "q", dev, tuple(_DTYPES))
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(t, name, dev, (q.dtype,))
        if t.data_ptr() % 16:  # the kernel copies the pools in 16-byte pieces
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        _check(t, name, dev, (torch.int32,))
    s, h, hd = q.shape
    _, page, hkv, hdk = k_pages.shape
    n_pages = page_table.shape[1]
    if (v_pages.shape != k_pages.shape or hdk != hd or h % hkv
            or tuple(page_table.shape) != (s, n_pages) or tuple(lengths.shape) != (s,)):
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)}, pools {tuple(k_pages.shape)}, "
            f"table {tuple(page_table.shape)}, lengths {tuple(lengths.shape)}")
    g = h // hkv
    if hd not in HEAD_DIMS or not 1 <= page <= MAX_PAGE or g > 32:
        raise ValueError(f"head_dim {hd} (of {HEAD_DIMS}), page {page} (<= {MAX_PAGE}) "
                         f"or group {g} (<= 32) not supported")
    splits, pps = split_plan(n_pages)
    out = torch.empty_like(q)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fedfog_paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], s, hkv, g, hd, page,
            n_pages, splits, pps, int(window), stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_attention: launch failed (code {rc})")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
