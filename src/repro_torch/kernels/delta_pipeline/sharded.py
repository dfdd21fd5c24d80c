"""The sharded server pass: the delta pipeline on one rank's client rows,
with ONE packed all-reduce per reduction tier (port of
``repro/kernels/delta_pipeline/sharded.py``).

The JAX package wraps the pipeline in a ``shard_map`` over the
client-sharded (C, P) buffer. Here each rank of a ``torch.distributed``
world runs the body itself on its own (C_local, P) rows: the exact
per-client half (clip norms through K2, since every client's row lives
on one rank; the compression table; the UNnormalized Eq. 6 partial sum
Σ dm_i·x_i through K4, ``ops.delta_pipeline_partial``), written into the
first P entries of one (P+2,) float32 vector whose last two are Σdm and
Σm. That vector is the round's ONE ``all_reduce`` over the client group,
the paper's one inter-client collective (``dist.collectives``
asserts it). The normalize → DP noise → momentum → apply epilogue
(:func:`combine_epilogue`) then runs replicated on every rank.

Fog tier (``fog_nodes > 1``): ``fog_nodes`` must equal the product of a
LEADING prefix of the client axes (``dist.meshes.split_fog_axes``; in a
multi-pod plan the pod axis is the fog tier). The combine is then one
packed all-reduce per tier: the edge suffix first (each fog
aggregator's partial; skipped when its extent is 1), then the fog
prefix (the cloud combine).

Numerics: the partials are summed in another order than the
single-device kernel's weighted sum, so the result equals
``delta_pipeline_apply`` to float tolerance, not bit for bit. The DP
noise is the caller's, drawn identically on every rank and added after
the reduction.

Robust aggregators (median / trimmed) need every client's coordinate on
one rank: they are not ported under rules (ROADMAP item 11(b)).
"""
from __future__ import annotations

import math

import torch

from repro_torch.dist.meshes import split_fog_axes

_EPS = 1e-12  # matches core.aggregation._EPS


def _norm_axes(client_axes) -> tuple[str, ...]:
    if isinstance(client_axes, str):
        return (client_axes,)
    return tuple(client_axes)


def combine_epilogue(
    agg_sum: torch.Tensor,  # (P,) combined UNnormalized weighted delta sum
    sdm: torch.Tensor,  # () Σ mask·|D|·staleness-discount
    sm: torch.Tensor,  # () Σ mask·|D|
    base: torch.Tensor,  # (P,) fused global model
    lr,
    *,
    has_stale: bool,
    dp_noise: torch.Tensor | None = None,
    momentum: torch.Tensor | None = None,
    server_optimizer: str = "fedavg",
    server_momentum: float = 0.9,
):
    """Cloud-side epilogue of every hierarchical combine: normalize → DP
    noise → server momentum / Adam → apply, the formulas of
    ``delta_pipeline_apply`` term for term. Returns ``(new_base,
    new_momentum or None)``.

    ``agg_sum`` (float32) is consumed: the aggregate, then the step and
    the new model are computed in its buffer, in the same operations and
    order as out of place. At P = 1.24·10⁹ each (P,) float32 temporary
    is 4.9 GB; only the new momentum gets a buffer of its own."""
    agg = agg_sum
    if has_stale:
        # normalize by Σdm, then the async_aggregate global damping
        agg.div_(sdm + _EPS)
        agg.mul_((sdm + _EPS) / (sm + _EPS))
    else:
        agg.div_(sm + _EPS)
    if dp_noise is not None:
        agg.add_(dp_noise.to(torch.float32))
    base32 = base.to(torch.float32)
    if momentum is not None:
        mu2 = (momentum.to(torch.float32) * server_momentum).add_(agg)
        if server_optimizer == "fedadam":
            step = torch.mul(mu2, lr).div_(agg.square_().sqrt_().add_(1e-3))
        else:  # fedavgm
            step = torch.mul(mu2, lr, out=agg)
        return step.add_(base32).to(base.dtype), mu2.to(momentum.dtype)
    return agg.mul_(lr).add_(base32).to(base.dtype), None


def _packed_all_reduce(packed: torch.Tensor, mesh, axes, fog_nodes: int) -> None:
    """The one cross-rank combine of the (P+2,) pack, per tier (none when
    the client axes span one rank: it holds every row)."""
    dist = torch.distributed
    if mesh.ways(axes) <= 1:
        return
    if fog_nodes > 1:
        fog_axes, edge_axes = split_fog_axes(mesh, axes, fog_nodes)
        if mesh.ways(edge_axes) > 1:  # edge -> fog: each fog's partial
            dist.all_reduce(packed, group=mesh.group(edge_axes))
        dist.all_reduce(packed, group=mesh.group(fog_axes))  # fog -> cloud
    else:
        dist.all_reduce(packed, group=mesh.group(axes))


def packed_partials(dm: torch.Tensor, m: torch.Tensor, p: int, fill) -> torch.Tensor:
    """The (P+2,) float32 pack ``[Σ dm_i·x_i, Σdm, Σm]``: ``fill(out)``
    writes the partial sum into its first P entries."""
    packed = torch.empty((p + 2,), dtype=torch.float32, device=dm.device)
    fill(packed[:p])
    packed[p:].copy_(torch.stack([torch.sum(dm), torch.sum(m)]))
    return packed


def reduce_and_combine(packed, base, lr, *, mesh, client_axes, fog_nodes: int = 1,
                       has_stale: bool = False, dp_noise=None, momentum=None,
                       server_optimizer: str = "fedavg", server_momentum: float = 0.9):
    """All-reduce a rank's (P+2,) pack over the client group (per tier with
    a fog tier), then the replicated epilogue. Returns ``(new_base,
    new_momentum or None)``."""
    p = packed.shape[0] - 2
    _packed_all_reduce(packed, mesh, _norm_axes(client_axes), fog_nodes)
    return combine_epilogue(
        packed[:p], packed[p], packed[p + 1], base, lr, has_stale=has_stale,
        dp_noise=dp_noise, momentum=momentum, server_optimizer=server_optimizer,
        server_momentum=server_momentum)


def delta_pipeline_apply_sharded(
    updates: torch.Tensor,  # (C_local, P) this rank's fused deltas
    base: torch.Tensor,  # (P,) fused global model (replicated)
    mask: torch.Tensor,  # (C_local,) this rank's participation rows
    weights: torch.Tensor,  # (C_local,) |D_i| of those rows
    lr=1.0,
    staleness: torch.Tensor | None = None,  # (C_local,)
    staleness_exponent=0.0,
    dp_noise: torch.Tensor | None = None,  # (P,) replicated, caller-built
    momentum: torch.Tensor | None = None,  # (P,) fused server momentum
    *,
    mesh,
    client_axes,
    fog_nodes: int = 1,
    clip_norm: float = 0.0,
    compression: str = "none",
    topk_fraction: float = 0.05,
    seg_sizes: tuple[int, ...] | None = None,
    server_optimizer: str = "fedavg",
    server_momentum: float = 0.9,
):
    """Sharded fused delta pipeline, called by every rank on its own rows:
    one K4 pass per rank, one packed all-reduce per reduction tier. Same
    gates and return convention as ``delta_pipeline_apply`` (fedavg
    aggregator only).

    On a degenerate mesh (the client axes span one rank) the rank holds
    every row: it runs ``delta_pipeline_apply`` (K3), or with a fog tier
    the single-host ``fl.fog.fog_pipeline_apply``, as the JAX function
    does."""
    from repro_torch.fl.fog import discounted_weights
    from repro_torch.kernels.delta_pipeline import ops

    axes = _norm_axes(client_axes)
    ways = math.prod(mesh.shape[a] for a in axes)
    kw = dict(clip_norm=clip_norm, compression=compression,
              topk_fraction=topk_fraction, seg_sizes=seg_sizes)
    epi = dict(server_optimizer=server_optimizer, server_momentum=server_momentum)
    if ways <= 1:
        args = (updates, base, mask, weights, lr, staleness, staleness_exponent,
                dp_noise, momentum)
        if fog_nodes > 1:
            from repro_torch.fl.fog import fog_pipeline_apply

            return fog_pipeline_apply(*args, fog_nodes=fog_nodes, **kw, **epi)
        return ops.delta_pipeline_apply(*args, **kw, **epi)

    has_mu = momentum is not None and server_optimizer in ("fedavgm", "fedadam")
    dm, m = discounted_weights(mask, weights, staleness, staleness_exponent)
    packed = packed_partials(
        dm, m, updates.shape[1],
        lambda out: ops.delta_pipeline_partial(updates, dm.contiguous(), out=out, **kw))
    out, mu2 = reduce_and_combine(
        packed, base, lr, mesh=mesh, client_axes=axes, fog_nodes=fog_nodes,
        has_stale=staleness is not None, dp_noise=dp_noise,
        momentum=momentum if has_mu else None, **epi)
    return (out, mu2) if has_mu else out
