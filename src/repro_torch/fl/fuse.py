"""Fused (C, P) client-delta buffers — the delta pipeline's data layout
(port of ``repro/fl/fuse.py``).

Leaves are concatenated in ``jax.tree.flatten`` order (dict keys sorted:
``[b, w]`` per layer), so the DP noise vector, the segment ids and the
compression table land on the same columns as in the JAX package.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch import tree
from repro_torch.random import flush_context


def fuse_clients(stacked):
    """Concat every (C, ...)-stacked leaf into ONE (C, P) f32 buffer.

    Returns the buffer and its inverse, which accepts an aggregated (P,)
    vector or a still-stacked (C, P) buffer."""
    flat = tree.leaves(stacked)
    shapes = [tuple(x.shape[1:]) for x in flat]
    dtypes = [x.dtype for x in flat]
    sizes = [math.prod(s) for s in shapes]
    cat = torch.cat(
        [x.reshape(x.shape[0], -1).to(torch.float32) for x in flat], dim=1
    )

    def unfuse(vec):
        parts = torch.split(vec, sizes, dim=-1)
        return tree.unflatten(
            stacked,
            [p.reshape(p.shape[:-1] + s).to(dt)
             for p, s, dt in zip(parts, shapes, dtypes)],
        )

    return cat, unfuse


def fuse_vector(params):
    """Concat an UNstacked parameter tree into one (P,) f32 vector, with
    the inverse (split + reshape + cast back)."""
    flat = tree.leaves(params)
    shapes = [tuple(x.shape) for x in flat]
    dtypes = [x.dtype for x in flat]
    sizes = [math.prod(s) for s in shapes]
    cat = torch.cat([x.reshape(-1).to(torch.float32) for x in flat])

    def unfuse(vec):
        parts = torch.split(vec, sizes)
        return tree.unflatten(
            params,
            [p.reshape(s).to(dt) for p, s, dt in zip(parts, shapes, dtypes)],
        )

    return cat, unfuse


def stacked_leaf_sizes(stacked) -> tuple[int, ...]:
    """Segment lengths of ``fuse_clients(stacked)`` (client axis excluded)."""
    return tuple(math.prod(x.shape[1:]) for x in tree.leaves(stacked))


# Ids of at most this many columns (64 MB of int32) are cached.
CACHED_COLUMNS = 1 << 24


def segment_ids(sizes: tuple[int, ...], device) -> torch.Tensor:
    """(P,) int32 leaf-segment id per fused-buffer column (callers do not
    write into it). A simulator-sized layout is built once per ``(sizes,
    device)`` and shared: its build copies ``sizes`` from the host, a copy
    that waits for the device queue, so a round must not make it again. A
    model-sized layout (more than ``CACHED_COLUMNS`` columns: 4.9 GB at
    llama3.2-1b's 1.24·10⁹) is built anew on each call by one fill per
    leaf, which waits for nothing, and is freed with its caller's last
    reference instead of holding the card's memory for the process."""
    sizes = tuple(int(s) for s in sizes)
    device = torch.device(device)
    if sum(sizes) <= CACHED_COLUMNS:
        return _segment_ids(sizes, device)
    ids = torch.empty((sum(sizes),), dtype=torch.int32, device=device)
    off = 0
    for i, n in enumerate(sizes):
        ids[off:off + n].fill_(i)
        off += n
    return ids


@functools.cache
def _segment_ids(sizes: tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.repeat_interleave(
        torch.arange(len(sizes), dtype=torch.int32, device=device),
        torch.tensor(sizes, device=device),
        output_size=sum(sizes),
    )


def fused_gaussian_noise(draws, std: float, sizes: tuple[int, ...], *, round: int,
                         uses: int = 0):
    """(P,) DP noise vector matching ``core.privacy.gaussian_mechanism``:
    the same ``dp`` normals, leaf by leaf, times ``std``; ``uses`` keys a
    repeat flush's draw (``random.flush_context``)."""
    z = draws.normal("dp", (sum(sizes),), segments=tuple(sizes),
                     **flush_context(round, uses))
    return std * z
