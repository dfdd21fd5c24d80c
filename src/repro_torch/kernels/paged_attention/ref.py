"""Plain PyTorch version of K7, paged decode attention (port of
``repro/kernels/paged_attention/ref.py``).

The oracle gathers each slot's pages into a contiguous
``(S, n_pages·page, Hkv, hd)`` cache and calls the decode attention the
sequential oracle runs (``models.layers.attention_decode``), so the paged
kernel and the serving engine are held against one and the same check.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import attention_decode


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """(P, page, Hkv, hd) pool + (S, n) table -> contiguous (S, n·page,
    Hkv, hd): position ``t`` of slot ``s`` lands at row ``t``."""
    s, n = page_table.shape
    g = pages[page_table.long()]  # (S, n, page, Hkv, hd)
    return g.reshape(s, n * pages.shape[1], *pages.shape[2:])


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor, window: int = -1) -> torch.Tensor:
    """q (S, H, hd), one query token per slot; ``lengths`` (S,) counts the
    slot's valid tokens INCLUDING the current one; ``window`` in the model
    convention (-1 = unbounded). Slots with length 0 return exact zeros."""
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    out = attention_decode(q[:, None], k, v, lengths - 1, window)[:, 0]
    return torch.where((lengths > 0)[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device)).to(q.dtype)
