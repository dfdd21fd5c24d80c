"""Federated training state and round configuration (port of
``repro/fl/state.py``).

Client slots are stateless between rounds, as in the paper's serverless
execution model: a training "function invocation" receives the global
model, runs E local steps with a fresh inner optimizer and returns a
delta. Only the global model, the server optimizer state and the
(N-client) scheduler state persist.

Two fields live on the host: ``rng``, the JAX package's (2,) uint32 key,
split every round as the JAX round splits it (``random.split_key``), so
that a checkpoint carries the same key in either package; and ``step``,
the round index, a Python int. The round keys its draws by ``step``
(``fl.round``), so it never reads a round counter back from the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.core.types import SchedulerState, init_scheduler_state
from repro_torch.device import resolve_device
from repro_torch.random import prng_key, split_key
from repro_torch.sim.faults.config import FaultConfig


@dataclasses.dataclass(frozen=True)
class FLState:
    params: Any  # global model tree (unstacked)
    server_mu: Any  # float32 server momentum tree, or None
    server_count: torch.Tensor  # () int32: server updates applied
    sched: SchedulerState  # N- (or M-) client scheduler state
    rng: np.ndarray  # (2,) uint32 key, on the host
    step: int  # round index, on the host


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """One place for every FedFog-round knob (the JAX package's fields and
    defaults)."""

    num_clients: int = 64  # N: scheduling window per round (registry rows)
    slots: int = 16  # C: concurrent hardware cohort slots
    # M: virtual client population (None -> dense: registry == window).
    # When set, the scheduler registry is (M,)-sized and each round samples
    # a stratified N-client window (the ``cohort`` draw), gathers its rows,
    # schedules / trains / aggregates at window and slot size, and
    # scatters the advanced rows back. The registry keeps the full
    # (M, hist_bins) drift table: batch histograms are caller data.
    population: int | None = None
    # F: fog tier width of the edge -> fog -> cloud reduction over the
    # slot axis (fl/fog.py). 1 = flat; > 1 requires aggregator="fedavg".
    fog_nodes: int = 1
    local_steps: int = 1  # E: local steps per round (Eq. 5)
    microbatch: int = 1  # gradient-accumulation splits per local step
    hist_bins: int = 64  # drift histogram buckets

    # Inner (client) optimizer, fresh every round (serverless).
    inner_optimizer: str = "sgdm"  # "sgdm" | "adamw"
    inner_lr: float = 0.02
    inner_momentum: float = 0.9

    # Server (outer) optimizer on aggregated deltas.
    server_optimizer: str = "fedavgm"  # "fedavg" | "fedavgm" | "fedadam"
    server_lr: float = 1.0
    server_momentum: float = 0.9

    # Aggregation and robustness.
    aggregator: str = "fedavg"  # "fedavg" | "median" | "trimmed"
    trim_fraction: float = 0.1  # trimmed-mean tail fraction per side
    clip_norm: float = 0.0  # per-client delta clip (0 = off); DP sensitivity S
    dp_sigma: float = 0.0  # central DP noise scale (0 = off)
    compression: str = "none"  # "none" | "int8" | "topk"
    topk_fraction: float = 0.05
    # Run the server side (clip, compression emulation, Eq. 6 or the
    # median / trimmed selection, DP noise, server momentum, apply) as the
    # fused delta-pipeline kernels over the (C, P) delta buffer: K3, or
    # one K4 per fog plus the cloud epilogue; K2 for the clip norms.
    use_pallas_agg: bool = False

    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)

    # Baseline switches (§IV.B): "fedfog" | "rcs" | "fogfaas" | "vanilla"
    policy: str = "fedfog"

    # Fault-injection and recovery plan (sim.faults). None or an all-off
    # plan leaves the round on its fault-free path.
    faults: FaultConfig | None = None

    def __post_init__(self):
        if not (self.slots >= 1 and self.num_clients >= self.slots):
            raise ValueError(
                f"need 1 <= slots <= num_clients, got slots={self.slots} "
                f"num_clients={self.num_clients}"
            )
        if self.population is not None and self.population < self.num_clients:
            raise ValueError(
                f"population={self.population} must be >= the scheduling "
                f"window num_clients={self.num_clients}"
            )
        from repro_torch.fl.fog import validate_fog_config

        validate_fog_config(self.fog_nodes, self.slots, self.aggregator)
        if self.faults is not None:
            from repro_torch.sim.faults.config import validate

            validate(self.faults)


def flat_zeros_like(params):
    """A float32 zero tree shaped like ``params`` whose leaves are views of
    ONE (P,) buffer in leaf order, the layout of the kernel path's fused
    vectors (the round then hands that buffer to K3 / K4 uncopied)."""
    flat = tree.leaves(params)
    buf = torch.zeros((sum(x.numel() for x in flat),), dtype=torch.float32,
                      device=flat[0].device)
    views, off = [], 0
    for x in flat:
        views.append(buf[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return tree.unflatten(params, views)


def init_fl_state(model, fl_cfg: FLConfig, key, server_mu: bool | None = None,
                  *, device=None, rules=None) -> FLState:
    """A fresh state on the CUDA card unless ``device`` names another.

    ``key`` is a seed (int) or a (2,) uint32 key in the JAX package's
    format; it is split into the parameters' key, which seeds the torch
    generator the model draws from, and the state's ``rng``, as the JAX
    package splits it (so ``rng`` equals the JAX state's; the parameters
    do not: see ``convert.fl_state_from_jax``).

    Under mesh ``rules`` (``dist.sharding.ShardingRules``) every rank
    calls this with the same key and gets the same global state, on its
    own device (``rules.mesh.device`` unless ``device`` names one); the
    slots must divide over the client ranks. On a plan with a model split
    the parameters and the server momentum are this rank's blocks of it
    (``ShardingRules.tensor_specs``, JAX ``fl_state_specs`` with ``zero``
    off the parameters); the rest stays replicated."""
    if rules is not None:
        rules.slot_range(fl_cfg.slots)  # raises unless the slots divide
        device = rules.mesh.device if device is None else device
    device = resolve_device(device)
    key = prng_key(key) if isinstance(key, (int, np.integer)) else np.asarray(key, np.uint32)
    k_params, k_rng = split_key(key, 2)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(k_params[0]) << 32) | int(k_params[1]))
    params = model.init(gen, rules)
    use_mu = (
        fl_cfg.server_optimizer in ("fedavgm", "fedadam")
        if server_mu is None
        else server_mu
    )
    return FLState(
        params=params,
        server_mu=flat_zeros_like(params) if use_mu else None,
        server_count=torch.zeros((), dtype=torch.int32, device=device),
        sched=init_scheduler_state(
            fl_cfg.population or fl_cfg.num_clients, fl_cfg.hist_bins,
            fl_cfg.scheduler.theta_e, device=device,
        ),
        rng=k_rng,
        step=0,
    )


def whole_state(state: FLState, tp) -> FLState:
    """A rank's state with its parameter and momentum blocks gathered over
    its model group into whole trees (a collective: every rank of the
    group calls it); ``tp`` None returns ``state``."""
    if tp is None:
        return state
    mu = state.server_mu
    return dataclasses.replace(state, params=tp.gather_tree(state.params),
                               server_mu=None if mu is None else tp.gather_tree(mu))


def rank_state(state: FLState, tp, device=None) -> FLState:
    """The inverse of :func:`whole_state`: this rank's blocks of a whole
    state's parameters and momentum, moved to ``device`` when given (the
    momentum as views of one flat buffer, as ``init_fl_state`` keeps
    it)."""
    if tp is None:
        return state
    params = tp.shard_tree(state.params)
    if device is not None:
        params = tree.map(lambda x: x.to(device), params)
    mu = None
    if state.server_mu is not None:
        mu = flat_zeros_like(params)
        for dst, src in zip(tree.leaves(mu), tree.leaves(tp.shard_tree(state.server_mu))):
            dst.copy_(src)
    return dataclasses.replace(state, params=params, server_mu=mu)


def abstract_fl_state(model, fl_cfg: FLConfig) -> FLState:
    """The dry run's shape-only state belongs to the distributed path."""
    raise NotImplementedError(
        "abstract_fl_state serves the sharded dry run (launch/dryrun.py), not "
        "ported yet: ROADMAP.md queue 1, item 11(b)"
    )
