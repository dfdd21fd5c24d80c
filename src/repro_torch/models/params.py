"""Parameter declarations (port of ``repro/models/params.py``).

Every parameter is declared once as ``ParamDecl(shape, axes, init,
dtype)``; :func:`init_tree` turns a nested dict of declarations into
tensors. The initial values come from an explicit ``torch.Generator``
and land on its device. The JAX package initialises from a key; the two
give different numbers, so a test that compares the packages carries the
JAX parameters across (``repro_torch.convert.model_params_from_jax``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

Array = torch.Tensor
_DRAW_ELEMENTS = 1 << 27  # float32 elements drawn at once (512 MB)


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # "normal" | "zeros" | "ones" | "normal_out"
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _fan_in(shape: tuple[int, ...]) -> int:
    # For stacked (layers, in, ..., out) weights, fan-in is the product of
    # all dims except the leading "layers" stack and the trailing out dim.
    if len(shape) <= 1:
        return max(shape[0] if shape else 1, 1)
    return max(math.prod(shape[:-1]) // (shape[0] if len(shape) > 2 else 1), 1)


def init_param(decl: ParamDecl, generator: torch.Generator) -> Array:
    dtype = getattr(torch, decl.dtype)
    dev = generator.device
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=dtype, device=dev)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=dtype, device=dev)
    std = 1.0 / math.sqrt(_fan_in(decl.shape))
    if decl.init == "normal_out":  # output-layer init, smaller
        std = std / 2.0
    # Drawn in float32 a few leading-axis slices at a time, so the float32
    # transient stays under _DRAW_ELEMENTS (a whole MoE expert stack, e.g.
    # moonshot's (48, 64, 2048, 1408), would need 35 GB of it).
    out = torch.empty(decl.shape, dtype=dtype, device=dev)
    rows = max(1, _DRAW_ELEMENTS // max(1, math.prod(decl.shape[1:])))
    for i in range(0, decl.shape[0], rows):
        part = out[i:i + rows]
        x = torch.randn(part.shape, generator=generator, dtype=torch.float32, device=dev)
        part.copy_(x.mul_(std))
    return out


def _leaves(decls, prefix=()):
    for k in sorted(decls):
        v = decls[k]
        if isinstance(v, ParamDecl):
            yield prefix + (k,), v
        else:
            yield from _leaves(v, prefix + (k,))


def init_tree(decls, generator: torch.Generator):
    """Nested dict of ParamDecl -> the same dict of tensors, drawn leaf by
    leaf in sorted key order from ``generator``."""
    out: dict = {}
    for path, decl in _leaves(decls):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = init_param(decl, generator)
    return out


def count(decls, active_expert_fraction: float | None = None) -> int:
    """Number of parameters declared; with ``active_expert_fraction``, an
    ``experts``-axis leaf counts by that share (rounded down per leaf, as
    the JAX package counts)."""
    total = 0
    for _, d in _leaves(decls):
        n = math.prod(d.shape)
        if active_expert_fraction is not None and "experts" in d.axes:
            n = int(n * active_expert_fraction)
        total += n
    return total
