"""Fog-tier hierarchical reduction — edge → fog → cloud (paper Fig. 1) —
and population / cohort sampling (port of ``repro/fl/fog.py``).

Eq. 6 is associative: the staleness-discounted weighted aggregate
decomposes into per-fog PARTIAL sums (each fog aggregator reduces only
its own clients) plus one small cloud combine of ``fog_nodes`` partials:

    partial_f = Σ_{i∈f} m_i·disc_i·Δ_i        (P,) per fog
    Σdm_f     = Σ_{i∈f} m_i·disc_i            scalar per fog
    Σm_f      = Σ_{i∈f} m_i                   scalar per fog
    cloud:  agg = (Σ_f partial_f) / (Σ_f Σdm_f + ε) · damping

which equals the flat aggregate up to float reassociation. Robust
aggregators (median / trimmed) are order statistics over the full client
axis and do not decompose, so ``fog_nodes > 1`` composes only with
``fedavg``. Two entries share the cloud-combine math:

  * :func:`fog_aggregate` — reference path: ``index_add_`` partials over
    an arbitrary client → fog assignment;
  * :func:`fog_pipeline_apply` — kernel path: one
    ``kernels.delta_pipeline.delta_pipeline_partial`` pass (K4) per fog's
    contiguous client block, then the replicated epilogue
    (``kernels.delta_pipeline.sharded.combine_epilogue``).

Population mode carries ``M`` virtual clients as cheap (M,) scheduler,
telemetry and profile rows; each round gathers a C-sized cohort, so all
model-sized work is built for C clients only. The cohort's ids are
sorted and distinct by construction, so gather and scatter are plain
index ops (``index_select``; ``index_copy_``, which writes the (M,) rows
IN PLACE: the registries are the round's carry, and a copy of each per
round would move ~60 MB at a million clients for nothing).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.drift import normalize_histogram
from repro_torch.core.types import PopulationSchedulerState, SchedulerState
from repro_torch.device import scalar

_EPS = 1e-12  # matches core.aggregation / kernels.delta_pipeline


# --------------------------------------------------------------------- #
# population / cohort sampling
# --------------------------------------------------------------------- #
def stratified_cohort(draws, population: int, cohort: int, *, round: int,
                      site: str = "cohort"):
    """Sample ``cohort`` distinct client ids from ``[0, population)``.

    Stratum ``i`` is ``[⌊i·M/C⌋, ⌊(i+1)·M/C⌋)`` and contributes one
    uniform id (the ``site`` draw of ``round``: ``cohort`` for a round,
    ``cohort.async`` for an async dispatch's candidates), so the ids come
    back sorted and distinct. With ``population == cohort`` every stratum
    has width 1 and the sample is ``arange(cohort)``.
    """
    bounds = torch.arange(cohort + 1, dtype=torch.int64, device=draws.device)
    bounds = (bounds * population) // cohort
    lo, hi = bounds[:-1], bounds[1:]
    width = torch.clamp(hi - lo, min=1)
    return lo + draws.randint(site, (cohort,), width, round=round)


def _fields(obj) -> dict:
    """The tensor fields of a per-client frozen dataclass, by name."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def gather_rows(rows, ids: torch.Tensor):
    """Row-gather every (N, ...) field of a per-client dataclass."""
    return type(rows)(**{k: torch.index_select(v, 0, ids)
                         for k, v in _fields(rows).items()})


def scatter_rows(pop, ids: torch.Tensor, rows, *, in_place: bool = False):
    """Write cohort ``rows`` into the per-population dataclass ``pop``.

    By default out of place, as JAX's ``.at[ids].set``: a new dataclass of
    new tensors (``Tensor.index_copy``), ``pop`` unchanged. With
    ``in_place=True`` the rows are written into ``pop``'s own tensors
    (``index_copy_``) and ``pop`` is returned; only a caller that owns
    ``pop`` (a run loop over its carry) may ask for that."""
    new = _fields(rows)
    copy = torch.Tensor.index_copy_ if in_place else torch.Tensor.index_copy
    out = {k: copy(v, 0, ids, new[k]) for k, v in _fields(pop).items()}
    return pop if in_place else type(pop)(**out)


def gather_cohort_sched(
    pop: PopulationSchedulerState, ids: torch.Tensor, hist_fn
) -> SchedulerState:
    """A cohort-sized ``SchedulerState`` from population rows.

    ``prev_hist`` is recomputed for the cohort: ``hist_fn(ids, rounds)``
    is deterministic in (client, round), so the histogram at each
    member's ``last_hist_round`` equals what ``schedule_round`` would have
    stored (``drift_score`` renormalizes both sides, so smoothing it once
    more here leaves the gate's value unchanged)."""
    take = lambda a: torch.index_select(a, 0, ids)  # noqa: E731
    return SchedulerState(
        prev_hist=normalize_histogram(hist_fn(ids, take(pop.last_hist_round))),
        theta_e=take(pop.theta_e),
        warm=take(pop.warm),
        last_used=take(pop.last_used),
        energy_spent=take(pop.energy_spent),
        round_index=pop.round_index,
    )


def scatter_cohort_sched(
    pop: PopulationSchedulerState,
    ids: torch.Tensor,
    cohort: SchedulerState,
    hist_round: int,
    *,
    in_place: bool = False,
) -> PopulationSchedulerState:
    """Write a cohort's advanced scheduler rows back into the population,
    recording ``hist_round`` as the round its histograms were taken at;
    unsampled clients keep their rows. Out of place by default (``pop``
    unchanged); ``in_place=True`` writes into ``pop``'s tensors, for a
    caller that owns them (see :func:`scatter_rows`)."""
    copy = torch.Tensor.index_copy_ if in_place else torch.Tensor.index_copy
    fill = torch.Tensor.index_fill_ if in_place else torch.Tensor.index_fill
    rows = {name: copy(getattr(pop, name), 0, ids, getattr(cohort, name))
            for name in ("theta_e", "warm", "last_used", "energy_spent")}
    rows["last_hist_round"] = fill(pop.last_hist_round, 0, ids, int(hist_round))
    return dataclasses.replace(pop, round_index=cohort.round_index, **rows)


def gather_sched_rows(sched: SchedulerState, ids: torch.Tensor) -> SchedulerState:
    """Window rows of a FULL (population-sized) ``SchedulerState``, the LM
    round's variant: its drift histograms are opaque caller data, so
    ``prev_hist`` stays materialised at (M, hist_bins)."""
    take = lambda a: torch.index_select(a, 0, ids)  # noqa: E731
    return SchedulerState(
        prev_hist=take(sched.prev_hist),
        theta_e=take(sched.theta_e),
        warm=take(sched.warm),
        last_used=take(sched.last_used),
        energy_spent=take(sched.energy_spent),
        round_index=sched.round_index,
    )


def scatter_sched_rows(pop: SchedulerState, ids: torch.Tensor,
                       rows: SchedulerState) -> SchedulerState:
    """Write a window's advanced rows back into the full ``SchedulerState``
    (out of place, as JAX's ``.at[ids].set``); unsampled clients keep
    theirs."""
    put = lambda name: torch.index_copy(  # noqa: E731
        getattr(pop, name), 0, ids, getattr(rows, name))
    return SchedulerState(
        prev_hist=put("prev_hist"),
        theta_e=put("theta_e"),
        warm=put("warm"),
        last_used=put("last_used"),
        energy_spent=put("energy_spent"),
        round_index=rows.round_index,
    )


# --------------------------------------------------------------------- #
# fog-tier reduction
# --------------------------------------------------------------------- #
def fog_assignment(num_clients: int, fog_nodes: int, device=None) -> torch.Tensor:
    """Default client → fog map: contiguous blocks (fog ``f`` owns clients
    ``[f·C/F, (f+1)·C/F)``), the layout the kernel path assumes."""
    return (torch.arange(num_clients, dtype=torch.int64, device=device)
            * fog_nodes) // num_clients


def discounted_weights(mask, weights, staleness, staleness_exponent):
    """``(dm, m)``: (C,) mask·|D| with the (1+s)^-a staleness discount, and
    without it."""
    m = mask.to(torch.float32) * weights.to(torch.float32)
    if staleness is None:
        return m, m
    s = torch.clamp(staleness.to(torch.float32), min=0.0)
    return m * (1.0 + s) ** (-scalar(staleness_exponent, m.device)), m


def fog_partial_sums(
    updates, mask, weights, fog_nodes: int, staleness=None,
    staleness_exponent=0.0, assignment=None,
):
    """Per-fog partial sums ``(partials (F, P), sdm (F,), sm (F,))``: each
    fog reduces only its own clients' rows. ``assignment`` (C,) int fog
    ids default to contiguous blocks."""
    c = updates.shape[0]
    dev = updates.device
    if assignment is None:
        assignment = fog_assignment(c, fog_nodes, dev)
    assignment = assignment.to(torch.int64)
    dm, m = discounted_weights(mask, weights, staleness, staleness_exponent)
    x = dm[:, None] * updates.to(torch.float32)
    partials = torch.zeros((fog_nodes, updates.shape[1]), dtype=torch.float32,
                           device=dev).index_add_(0, assignment, x)
    sdm = torch.zeros((fog_nodes,), device=dev).index_add_(0, assignment, dm)
    sm = torch.zeros((fog_nodes,), device=dev).index_add_(0, assignment, m)
    return partials, sdm, sm


def cloud_combine(partials, sdm, sm, has_stale: bool):
    """Cloud tier: the fog partials -> the normalized aggregate (Σ
    partial / (Σdm + ε), then the ``async_aggregate`` damping with
    staleness)."""
    agg_sum = torch.sum(partials, dim=0)
    tdm, tm = torch.sum(sdm), torch.sum(sm)
    if has_stale:
        agg = agg_sum / (tdm + _EPS)
        return agg * ((tdm + _EPS) / (tm + _EPS))
    return agg_sum / (tm + _EPS)


def fog_aggregate(
    updates, mask, weights, fog_nodes: int, staleness=None,
    staleness_exponent=0.0, assignment=None,
):
    """Hierarchical Eq. 6 on one host: fog partials -> cloud combine.
    Equals ``fedavg_stacked`` (no staleness) up to float reassociation,
    for any client -> fog assignment."""
    partials, sdm, sm = fog_partial_sums(
        updates, mask, weights, fog_nodes, staleness, staleness_exponent,
        assignment,
    )
    return cloud_combine(partials, sdm, sm, staleness is not None)


def fog_aggregate_tree(
    deltas, mask, weights, fog_nodes: int, staleness=None,
    staleness_exponent=0.0,
):
    """Tree wrapper for the reference path: fuse -> fog_aggregate ->
    unfuse, so stacked deltas take the same hierarchical math."""
    from repro_torch.fl.fuse import fuse_clients

    cat, unfuse = fuse_clients(deltas)
    return unfuse(fog_aggregate(
        cat, mask, weights, fog_nodes, staleness, staleness_exponent
    ))


def fog_pipeline_apply(
    updates,  # (C, P) fused client deltas
    base,  # (P,) fused global model
    mask,
    weights,
    lr=1.0,
    staleness=None,
    staleness_exponent=0.0,
    dp_noise=None,  # (P,) caller-built
    momentum=None,  # (P,) fused server momentum
    *,
    fog_nodes: int,
    clip_norm: float = 0.0,
    compression: str = "none",
    topk_fraction: float = 0.05,
    seg_sizes: tuple[int, ...] | None = None,
    server_optimizer: str = "fedavg",
    server_momentum: float = 0.9,
):
    """Kernel path of the fog tier (fedavg only): each fog's contiguous
    (C/F, P) block takes ONE K4 pass (clip norms and compression tables
    fog-local), the cloud sums the F partials and runs the replicated
    epilogue. Returns the new (P,) model, or ``(model, new_mu)`` with a
    momentum server optimizer, as ``delta_pipeline_apply`` does."""
    from repro_torch.kernels.delta_pipeline.ops import delta_pipeline_partial
    from repro_torch.kernels.delta_pipeline.sharded import combine_epilogue

    c = updates.shape[0]
    if c % fog_nodes:
        raise ValueError(f"client count {c} not divisible by fog_nodes {fog_nodes}")
    per_fog = c // fog_nodes
    has_mu = momentum is not None and server_optimizer in ("fedavgm", "fedadam")
    dm, m = discounted_weights(mask, weights, staleness, staleness_exponent)
    total, sdm, sm = None, [], []
    for f in range(fog_nodes):
        sl = slice(f * per_fog, (f + 1) * per_fog)
        partial = delta_pipeline_partial(
            updates[sl], dm[sl].contiguous(), clip_norm=clip_norm,
            compression=compression, topk_fraction=topk_fraction,
            seg_sizes=seg_sizes,
        )
        # the cloud's sum, partial by partial in fog order: one (P,)
        # accumulator, not F partials alive at once
        total = partial if total is None else total.add_(partial)
        del partial
        sdm.append(torch.sum(dm[sl]))
        sm.append(torch.sum(m[sl]))
    out, mu2 = combine_epilogue(
        total, sum(sdm[1:], sdm[0]), sum(sm[1:], sm[0]),
        base, lr, has_stale=staleness is not None, dp_noise=dp_noise,
        momentum=momentum if has_mu else None,
        server_optimizer=server_optimizer, server_momentum=server_momentum,
    )
    return (out, mu2) if has_mu else out


def validate_fog_config(fog_nodes: int, num_clients: int, aggregator: str) -> None:
    """Fog-tier config checks shared by every entry point."""
    if fog_nodes < 1:
        raise ValueError(f"fog_nodes must be >= 1, got {fog_nodes}")
    if fog_nodes == 1:
        return
    if num_clients % fog_nodes:
        raise ValueError(
            f"fog_nodes={fog_nodes} must divide the cohort size {num_clients}"
        )
    if aggregator != "fedavg":
        raise ValueError(
            f"aggregator={aggregator!r} is an order statistic over the full "
            "client axis; it does not decompose into fog partials "
            "(fog_nodes > 1 requires aggregator='fedavg')"
        )
