"""Client-delta compression emulation (port of ``repro/fl/compression.py``).

  * int8: per-leaf symmetric quantization (scale = max|x| / 127).
  * topk: keep the largest-|x| fraction per leaf, zero the rest.

Both quantize and dequantize in place, so aggregation stays f32;
``wire_bytes_per_param`` feeds the DES energy/latency model. The fused
path makes one pass over the (C, P) buffer with the (C, L) table of
``kernels.delta_pipeline.segment_table``; it equals the per-leaf path
bitwise (same reduction elements, same elementwise ops).
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.fl.fuse import fuse_clients, segment_ids, stacked_leaf_sizes


def compress_int8(deltas):
    """Quantize -> dequantize each leaf (client dim preserved)."""
    def one(l):
        x = l.to(torch.float32)
        red = tuple(range(1, x.dim()))
        scale = torch.amax(torch.abs(x), dim=red, keepdim=True) / 127.0 + 1e-12
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return (q.to(torch.float32) * scale).to(l.dtype)

    return tree.map(one, deltas)


def compress_topk(deltas, fraction: float):
    """Keep the top-|fraction| magnitude entries per (client, leaf)."""
    def one(l):
        x = l.to(torch.float32)
        flat = x.reshape(x.shape[0], -1)
        k = max(1, int(flat.shape[1] * fraction))
        thresh = torch.topk(torch.abs(flat), k, dim=1).values[:, -1:]
        keep = torch.abs(flat) >= thresh
        return (flat * keep).reshape(x.shape).to(l.dtype)

    return tree.map(one, deltas)


def _compress_fused(deltas, kind: str, fraction: float):
    from repro_torch.kernels.delta_pipeline import segment_table

    cat, unfuse = fuse_clients(deltas)
    sizes = stacked_leaf_sizes(deltas)
    seg = segment_ids(sizes, device=cat.device).to(torch.int64)
    tab = segment_table(cat, kind, fraction, sizes)
    if kind == "int8":
        scale = tab[:, seg]
        q = torch.clamp(torch.round(cat / scale), -127, 127).to(torch.int8)
        return unfuse(q.to(torch.float32) * scale)
    thresh = tab[:, seg]
    return unfuse(cat * (torch.abs(cat) >= thresh))


def apply_compression(
    deltas, kind: str, topk_fraction: float = 0.05, *, fused: bool = True
):
    if kind == "none":
        return deltas
    if fused and len(tree.leaves(deltas)) > 1:
        if kind in ("int8", "topk"):
            return _compress_fused(deltas, kind, topk_fraction)
        raise ValueError(f"unknown compression {kind!r}")
    if kind == "int8":
        return compress_int8(deltas)
    if kind == "topk":
        return compress_topk(deltas, topk_fraction)
    raise ValueError(f"unknown compression {kind!r}")


def wire_bytes_per_param(kind: str, topk_fraction: float = 0.05) -> float:
    """Uplink bytes per parameter under each scheme (bf16 baseline)."""
    if kind == "none":
        return 2.0
    if kind == "int8":
        return 1.0
    if kind == "topk":
        return topk_fraction * 6.0  # value (2B) + index (4B) per kept entry
    raise ValueError(kind)
