"""The RWKV6 recurrence: K6.

``ops.wkv6`` is the public entry point; ``ref.wkv6_ref`` is the
sequential recurrence every kernel change is held against.
"""
from repro_torch.kernels.wkv6.ops import wkv6, wkv6_plain
from repro_torch.kernels.wkv6.ref import wkv6_ref

__all__ = ["wkv6", "wkv6_plain", "wkv6_ref"]
