"""Public entry point of K5 (port of ``repro/kernels/flash_attention/ops.py``).

Takes the model layout (B, S, H, hd) and the model's window convention
(``-1``/GLOBAL = unbounded; the kernel's is 0). A CPU tensor goes to the
plain version (``ref.py``), a CUDA tensor to the hand-written kernel
(``flash_attention.py``), which reads the model layout through strides;
anything else raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions=None, k_positions=None, window: int = -1, *,
                    bidirectional: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, hd), k/v: (B, Sk, Hkv, hd) -> (B, Sq, H, hd); q rows
    sit at the tail of the key timeline (positions are not read)."""
    del q_positions, k_positions  # contiguous tail-aligned layout assumed
    win = -1 if window is None else int(window)
    win = 0 if win < 0 else win  # kernel convention: 0 = global
    if q.device.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), window=win,
                                  bidirectional=bidirectional)
        return out.transpose(1, 2)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, window=win, bidirectional=bidirectional)
    raise ValueError(f"no flash-attention kernel for device {q.device}")
