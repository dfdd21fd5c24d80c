"""Paged decode attention for the continuous-batching slot batch: K7.

``ops.paged_attention`` is the public entry point; ``ref.paged_attention_ref``
is the dense-gather oracle every kernel change is held against.
"""
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import gather_pages, paged_attention_ref

__all__ = ["gather_pages", "paged_attention", "paged_attention_ref"]
