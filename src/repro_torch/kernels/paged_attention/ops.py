"""Public entry point of K7 (port of ``repro/kernels/paged_attention/ops.py``).

Takes the serving engine's layout: q (S, H, hd), one query token per slot,
the physical page pools (P, page, Hkv, hd), the (S, n_pages) page table
and the (S,) lengths, with the model's window convention (-1 =
unbounded; the kernel's is 0). A CPU tensor goes to the plain version
(``ref.py``), a CUDA tensor to the hand-written kernel
(``paged_attention.py``); anything else raises. Empty slots (length 0)
come out as zeros, as in the JAX wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.paged_attention import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor,
                    window: int = -1) -> torch.Tensor:
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths, window)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for device {q.device}")
    win = -1 if window is None else int(window)
    out = paged_attention_cuda(q, k_pages, v_pages, page_table, lengths,
                               window=0 if win < 0 else win)
    return torch.where((lengths > 0)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))
