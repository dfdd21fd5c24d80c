"""Paper-scale FedFog simulator, synchronous mode (port of
``repro/fl/simulator.py``).

N edge clients train a small MLP on the EMNIST-like or HAR-like task
under the full scheduler (Eqs. 1-12), the §IV.F latency / energy model,
drift injection, the §IV.D attacks and, with ``faults``, fault injection
and recovery (``sim.faults``: retries, deadline, quorum, fog outages).
All N clients are batched: their weights are stacked as (N, in, out) and
trained with ``torch.bmm``.

With ``population`` M > N the (M,) registries (telemetry, profiles,
scheduler rows, data sizes, attacker flags) stay on the device and each
round samples a stratified N-client cohort, gathers its rows, runs the
same round at cohort size and scatters the advanced rows back
(``fl.fog``). With ``fog_nodes`` F > 1 the Eq. 6 reduction runs edge →
fog → cloud: each of F fog aggregators reduces its contiguous block of
N/F clients (K4 on the kernel path) and the cloud combines the partials.

Two engines share ONE round function (``_round``):

  * ``run()``         — per-round loop, metrics moved to the host each round.
  * ``run_scanned()`` — the same rounds with the per-round metrics stacked
                        on the device and moved to the host ONCE at the end;
                        ``aot_scanned()`` / ``run_scanned_with()`` split it
                        into a program checked against a same-shape peer
                        and its run (eager: nothing is compiled).

The event-driven engine (``sim.events.AsyncFedFogSimulator``) composes
this class and shares its state init, histograms, participation, local
training, cost model and eval; ``sim.sweep.run_sweep`` drives either
engine over a configuration grid and a seed batch.

The round reads nothing back from the device (no ``.item()``, no
``.cpu()``) and keeps static shapes: participation is a mask over the
fixed client registry, never a gather. A ``MetricTap`` (``obs.tap``)
streams decimated rows out of either engine; it reads the metrics and
changes nothing.

With ``use_pallas_agg=True`` the server side (Eq. 6 weighting or the
median / trimmed selection, DP noise, apply) runs as the fused
delta-pipeline kernel on CUDA tensors (``kernels.delta_pipeline``: K3,
or one K4 per fog); on CPU tensors the same entry points run their plain
versions.

Random draws come from a draw provider (``repro_torch.random``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.core import aggregation as agg_mod
from repro_torch.core import privacy as privacy_mod
from repro_torch.core.scheduler import SchedulerConfig, account_energy, schedule_round
from repro_torch.core.selection import random_selection_mask, topk_mask
from repro_torch.core.types import (
    init_population_scheduler_state,
    init_scheduler_state,
    static_on,
)
from repro_torch.data import emnist_like, har_like
from repro_torch.data.telemetry import (
    TelemetryConfig,
    init_telemetry,
    make_profiles,
    step_telemetry,
)
from repro_torch.device import resolve_device
from repro_torch.fl import attacks as attacks_mod
from repro_torch.fl import fog as fog_mod
from repro_torch.fl.compression import apply_compression, wire_bytes_per_param
from repro_torch.fl.fuse import (
    fuse_clients,
    fuse_vector,
    fused_gaussian_noise,
    stacked_leaf_sizes,
)
from repro_torch.obs.history import finalize_history, summary_metrics
from repro_torch.obs.ranges import profiler_range
from repro_torch.optim import clip_by_global_norm
from repro_torch.random import TorchDraws
from repro_torch.sim.des import FaasSimConfig, RoundCostModel
from repro_torch.sim.faults import config as faults_config
from repro_torch.sim.faults import inject as faults_inject

def _phase(name: str):
    """The ``round.<name>`` profiler range of a phase of ``_round``."""
    return profiler_range(f"round.{name}")


# --------------------------------------------------------------------- #
# Small model (MLP) for the edge tasks
# --------------------------------------------------------------------- #
def mlp_init(draws, sizes: tuple[int, ...]):
    """He-normal weights from the ``init.mlp`` site, zero biases."""
    params = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        z = draws.normal("init.mlp", (a, b), index=i)
        params.append({"w": z * (2.0 / a) ** 0.5, "b": torch.zeros_like(z[0])})
    return params


def mlp_apply(params, x):
    """``x @ w + b`` per layer, ReLU between layers. Leaves may carry a
    leading client axis: (C, in, out) weights with (C, B, in) inputs."""
    for i, layer in enumerate(params):
        w, b = layer["w"], layer["b"]
        if w.dim() == 3:
            x = torch.bmm(x, w) + b[:, None, :]
        else:
            x = x @ w + b
        if i < len(params) - 1:
            x = F.relu(x)
    return x


def _ce_loss_sum(params, x, y):
    """Σ over clients of each client's mean cross-entropy: the gradient
    with respect to client c's weights is c's own mean-loss gradient."""
    logp = torch.log_softmax(mlp_apply(params, x), dim=-1)
    nll = -torch.gather(logp, -1, y[..., None])[..., 0]
    return torch.sum(torch.mean(nll, dim=-1))


# --------------------------------------------------------------------- #
# Simulator
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    task: str = "emnist"  # "emnist" | "har"
    num_clients: int = 64
    rounds: int = 50
    local_epochs: int = 3  # E in Eq. 5
    local_batch: int = 32
    lr: float = 0.05  # η in Eq. 5
    policy: str = "fedfog"  # fedfog | rcs | fogfaas | vanilla
    top_k: int | None = 24  # participation budget per round
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    telemetry: TelemetryConfig | None = None
    faas: FaasSimConfig = dataclasses.field(default_factory=FaasSimConfig)
    drift_period: int = 0  # inject drift every k rounds (0 = off)
    attack: str = "none"
    attack_fraction: float = 0.0
    attack_noise_scale: float = 0.05
    attack_replacement_scale: float = 1.0
    compression: str = "none"
    dp_sigma: float = 0.0
    clip_norm: float = 0.0
    server_lr: float = 1.0
    aggregator: str = "fedavg"  # "fedavg" | "median" | "trimmed"
    trim_fraction: float = 0.1  # trimmed-mean tail fraction per side
    # Route aggregation + DP noise + server apply through the fused
    # delta-pipeline kernel (kernels.delta_pipeline): one pass over the
    # fused (N, P) delta buffer. The name is the JAX package's.
    use_pallas_agg: bool = False
    population: int | None = None
    fog_nodes: int = 1
    faults: Any = None
    hidden: tuple[int, ...] = (128, 64)
    seed: int = 0

    def data_cfg(self):
        if self.task == "emnist":
            return emnist_like.EmnistLikeConfig(
                drift_period=self.drift_period, seed=self.seed
            )
        return har_like.HarLikeConfig(drift_period=self.drift_period, seed=self.seed)

    def dims(self):
        if self.task == "emnist":
            return 28 * 28, 62
        return har_like.WINDOW * har_like.CHANNELS, har_like.NUM_CLASSES


_ATTACKS = ("none", "label_flip", "noise", "model_replacement", "dropout")


def _check_supported(cfg: SimulatorConfig) -> None:
    if cfg.task not in ("emnist", "har"):
        raise ValueError(f"unknown task {cfg.task!r}")
    if cfg.attack not in _ATTACKS:
        raise ValueError(f"unknown attack {cfg.attack!r}")
    if cfg.aggregator not in ("fedavg", "median", "trimmed"):
        raise ValueError(f"unknown aggregator {cfg.aggregator!r}")


class FedFogSimulator:
    def __init__(
        self, cfg: SimulatorConfig, *, device: str | torch.device | None = None,
        draws=None, defer_state: bool = False, tap=None,
    ):
        """``device`` defaults to CUDA (raises without one); pass "cpu"
        to run on the CPU. ``draws`` is the draw provider, by default the
        production :class:`repro_torch.random.TorchDraws` seeded from
        ``cfg.seed``. ``defer_state`` skips the eager state build. ``tap``
        (a :class:`repro_torch.obs.MetricTap`) streams decimated rows out
        of ``run()`` and ``run_scanned()``; None or a disabled tap adds
        nothing to either."""
        _check_supported(cfg)
        self.cfg = cfg
        self.tap = tap if (tap is not None and tap.enabled) else None
        # Population / cohort split: the registries live at M, all
        # model-sized work at the cohort size C = num_clients. Dense mode
        # (population None or C) is the flat round, unchanged.
        self.population = cfg.population or cfg.num_clients
        self._pop_mode = self.population != cfg.num_clients
        if self.population < cfg.num_clients:
            raise ValueError(
                f"population={cfg.population} must be >= the cohort size "
                f"num_clients={cfg.num_clients}"
            )
        fog_mod.validate_fog_config(cfg.fog_nodes, cfg.num_clients, cfg.aggregator)
        # ONE gate for the whole fault layer: off, the round is unchanged.
        self._faults_on = faults_config.active(cfg.faults)
        if cfg.faults is not None:
            faults_config.validate(cfg.faults)
        self.device = resolve_device(device)
        self.draws = draws if draws is not None else TorchDraws(cfg.seed, self.device)
        # α, β on the device once: a round copies nothing from the host.
        self._sched_weights = cfg.scheduler.weights(self.device)
        self.data_cfg = cfg.data_cfg()
        in_dim, n_cls = cfg.dims()
        self.num_classes = n_cls
        self.sizes = (in_dim,) + tuple(cfg.hidden) + (n_cls,)
        self.tel_cfg = cfg.telemetry or TelemetryConfig(
            num_clients=self.population, seed=cfg.seed
        )
        if self.tel_cfg.num_clients != self.population:
            raise ValueError(
                f"telemetry.num_clients={self.tel_cfg.num_clients} must "
                f"match the population size {self.population}"
            )
        # Cohort-sized config for stepping the gathered telemetry rows.
        self._tel_cfg_cohort = dataclasses.replace(
            self.tel_cfg, num_clients=cfg.num_clients
        )
        self.n_mal = int(round(cfg.attack_fraction * self.population))
        self.cost_model = RoundCostModel(cfg.faas)
        self.n_params = sum(a * b + b for a, b in zip(self.sizes[:-1], self.sizes[1:]))
        # Matrix products in full float32, as JAX computes them on the CPU
        # (the defaults of recent PyTorch; stated here because the parity
        # with the JAX package depends on them).
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # The task's data module and class constants: EMNIST's templates,
        # HAR's per-class signals.
        if cfg.task == "emnist":
            self._data = emnist_like
            self._task_consts = emnist_like._templates(self.data_cfg, self.draws)
        else:
            self._data = har_like
            self._task_consts = har_like._class_params(self.data_cfg, self.draws)
        self.env = self.params = self.sched_state = self.telemetry = None
        if not defer_state:
            self._ensure_state()

    def _ensure_state(self):
        if self.env is None:
            env, params, sched, tel = self.init_state(self.cfg.seed)
            self.env = env
            self.params, self.sched_state, self.telemetry = params, sched, tel

    @property
    def profiles(self):
        return None if self.env is None else self.env["profiles"]

    # ------------------------------------------------------------------ #
    def init_state(self, seed: int):
        """State init: (env, params, sched_state, telemetry), drawn from
        the provider (whose seed is ``seed``)."""
        cfg, draws, n = self.cfg, self.draws, self.population
        if int(seed) != getattr(draws, "seed", int(seed)):
            raise ValueError(f"seed={seed} differs from the provider's {draws.seed}")
        with torch.no_grad():
            params = mlp_init(draws, self.sizes)
            profiles = make_profiles(self.tel_cfg, draws)
            telemetry = init_telemetry(self.tel_cfg, draws)
            if self._pop_mode:
                # (M,) rows, no (M, V) histogram table: the drift reference
                # is recomputed per cohort from last_hist_round.
                sched = init_population_scheduler_state(
                    n, cfg.scheduler.theta_e, device=self.device
                )
            else:
                sched = init_scheduler_state(
                    n, self.num_classes, cfg.scheduler.theta_e, device=self.device
                )
                # Bootstrap the drift reference with the true round-0
                # distributions, otherwise round 0 flags every client.
                sched = dataclasses.replace(
                    sched, prev_hist=self._histograms(self.data_cfg, 0)
                )
            data_sizes = torch.exp(
                draws.normal("data_sizes", (n,)) * 0.5
                + torch.log(torch.tensor(300.0, device=self.device))
            )
            if self._pop_mode and self.n_mal == 0:
                # No attackers: skip an O(M log M) permutation of all-False
                # flags (the JAX package skips it the same way).
                malicious = torch.zeros((n,), dtype=torch.bool, device=self.device)
            else:
                perm = draws.permutation("malicious", n)
                malicious = (torch.arange(n, device=self.device) < self.n_mal)[perm]
        env = {
            "profiles": profiles,
            "data_sizes": data_sizes,
            "malicious": malicious,
            "data_seed": int(seed),
        }
        return env, params, sched, telemetry

    # ------------------------------------------------------------------ #
    def _histograms(self, data_cfg, round_idx, ids=None):
        """(C, K) histograms of the dense registry or of cohort ``ids``;
        ``round_idx`` an int or, per client, a (C,) tensor."""
        return self._data.client_histogram(
            data_cfg, self.draws, self.cfg.num_clients, round_idx, ids=ids
        )

    def _participation(self, decision, telemetry, round_idx: int):
        cfg = self.cfg
        if cfg.policy == "fedfog":
            mask = decision.selection.mask
            if cfg.top_k is not None:
                mask = topk_mask(decision.selection.utility, mask, cfg.top_k)
        elif cfg.policy == "rcs":
            k = cfg.top_k if cfg.top_k is not None else cfg.num_clients
            perm = self.draws.permutation("rcs.perm", cfg.num_clients, round=round_idx)
            mask = random_selection_mask(perm, k)
        else:  # fogfaas / vanilla: everyone alive participates
            mask = telemetry.batt > 0.05
        return mask

    def _local_deltas(self, data_cfg, params, round_idx: int, mask, malicious,
                      ids=None):
        """E local epochs of SGD on every client at once (Eq. 5), then
        clip, attack and compression. Returns ``(deltas, mask)``: deltas
        is the params tree with a leading client axis; ``mask`` loses the
        attackers under the dropout attack. ``ids`` are the cohort's
        client ids in population mode."""
        cfg, n = self.cfg, self.cfg.num_clients
        e, b = cfg.local_epochs, cfg.local_batch
        x, y = self._data.client_batch(
            data_cfg, self.draws, n, round_idx, b * e, self._task_consts, ids=ids
        )
        if cfg.attack == "label_flip":
            y = attacks_mod.flip_labels(y, malicious, self.num_classes)
        xs = x.reshape(n, e, b, -1)
        ys = y.reshape(n, e, b)
        start = tree.map(lambda p: p.expand((n,) + tuple(p.shape)), params)
        cur = start
        for ep in range(e):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True) for t in tree.leaves(cur)]
                p = tree.unflatten(cur, leaves)
                loss = _ce_loss_sum(p, xs[:, ep], ys[:, ep])
                grads = torch.autograd.grad(loss, leaves)
            cur = tree.unflatten(
                cur, [w.detach() - cfg.lr * g for w, g in zip(leaves, grads)]
            )
        deltas = tree.map(lambda a, s: a - s, cur, start)
        if cfg.clip_norm > 0:
            deltas, _ = clip_by_global_norm(deltas, cfg.clip_norm, per_client=True)
        if cfg.attack not in ("none", "label_flip"):
            deltas = attacks_mod.corrupt_deltas(
                deltas, malicious & mask, cfg.attack, self.draws, round=round_idx,
                noise_scale=cfg.attack_noise_scale,
                replacement_scale=cfg.attack_replacement_scale,
            )
            mask = attacks_mod.dropout_mask(mask, malicious, cfg.attack)
        deltas = apply_compression(deltas, cfg.compression)
        return deltas, mask

    def _round_workload(self):
        """(workload_flops, upload_bytes, download_bytes) per client-round."""
        cfg = self.cfg
        workload = 6.0 * self.n_params * cfg.local_batch * cfg.local_epochs
        up_bytes = wire_bytes_per_param(cfg.compression) * self.n_params
        return workload, up_bytes, 2.0 * self.n_params

    def _eval_accuracy(self, data_cfg, params, round_idx: int, uses: int = 0):
        """Held-out accuracy on a 512-sample eval batch; ``uses`` keys the
        batch of a repeat flush of the async engine."""
        x, y = self._data.eval_batch(data_cfg, self.draws, round_idx, 512,
                                     self._task_consts, uses)
        logits = mlp_apply(params, x)
        return torch.mean((torch.argmax(logits, -1) == y).to(torch.float32))

    # ------------------------------------------------------------------ #
    def _apply_deltas(self, params, deltas, mask, data_sizes, round_idx: int):
        """Aggregate the client deltas and apply the server update; with
        ``fog_nodes > 1`` the Eq. 6 reduction runs fog partials -> cloud
        combine (``fl.fog``) on both the kernel and the reference path."""
        cfg = self.cfg
        if cfg.use_pallas_agg:
            # Fused delta pipeline: Eq. 6 weighting (or the median /
            # trimmed selection) + DP noise + apply in ONE pass over the
            # fused (N, P) buffer (K3), or one K4 pass per fog block plus
            # the cloud epilogue; clip/compression already happened in
            # _local_deltas. The DP noise is the reference path's draws.
            from repro_torch.kernels.delta_pipeline import delta_pipeline_apply

            cat_d, _ = fuse_clients(deltas)
            base_flat, unfuse_vec = fuse_vector(params)
            noise = None
            if static_on(cfg.dp_sigma):
                noise = fused_gaussian_noise(
                    self.draws, cfg.dp_sigma * (cfg.clip_norm or 1.0),
                    stacked_leaf_sizes(deltas), round=round_idx,
                )
            if cfg.fog_nodes > 1:
                new_flat = fog_mod.fog_pipeline_apply(
                    cat_d, base_flat, mask, data_sizes, lr=cfg.server_lr,
                    dp_noise=noise, fog_nodes=cfg.fog_nodes,
                )
            else:
                new_flat = delta_pipeline_apply(
                    cat_d, base_flat, mask, data_sizes,
                    lr=cfg.server_lr, dp_noise=noise,
                    trim_fraction=cfg.trim_fraction, aggregator=cfg.aggregator,
                )
            return unfuse_vec(new_flat)
        if cfg.aggregator == "median":
            agg = agg_mod.median_aggregate(deltas, mask)
        elif cfg.aggregator == "trimmed":
            agg = agg_mod.trimmed_mean_aggregate(deltas, mask, cfg.trim_fraction)
        elif cfg.fog_nodes > 1:
            agg = fog_mod.fog_aggregate_tree(deltas, mask, data_sizes, cfg.fog_nodes)
        else:
            agg = agg_mod.fedavg_stacked(deltas, mask, data_sizes)
        if static_on(cfg.dp_sigma):
            agg = privacy_mod.gaussian_mechanism(
                agg, self.draws,
                privacy_mod.DPConfig(
                    sigma=cfg.dp_sigma, sensitivity=cfg.clip_norm or 1.0
                ),
                round=round_idx,
            )
        return tree.map(lambda p, a: p + cfg.server_lr * a, params, agg)

    # ------------------------------------------------------------------ #
    def _plan_faults(self, round_idx: int, mask, warm, deltas, costs):
        """Realize one round's faults (``sim.faults.inject``) from the
        ``faults.*`` sites. Returns ``(plan, deltas)`` with the corrupted
        payloads' noise already added (the noise attack's arithmetic from
        the ``faults.noise`` site, accounted as a fault)."""
        fc = self.cfg.faults
        plan = faults_inject.plan_round(
            fc, self.draws, mask, ~warm, costs.per_client_ms,
            fog_nodes=self.cfg.fog_nodes, round=round_idx,
        )
        if static_on(fc.corrupt_rate):  # else no payload is corrupted
            deltas = attacks_mod.corrupt_deltas(
                deltas, plan.corrupt, "noise", self.draws, round=round_idx,
                site="faults.noise", noise_scale=fc.corrupt_scale,
            )
        return plan, deltas

    # ------------------------------------------------------------------ #
    def _gather_cohort(self, env, sched_state, telemetry, data_cfg, round_idx):
        """Population mode: sample the round's cohort and gather its rows.
        Returns ``(ids, sched, tel, profiles, data_sizes, malicious, hist)``
        at cohort size; the drift reference is recomputed at each member's
        last-observed round (with drift off the histograms do not depend on
        the round, so this round's serve)."""
        cfg = self.cfg
        ids = fog_mod.stratified_cohort(
            self.draws, self.population, cfg.num_clients, round=round_idx
        )
        hist = self._histograms(data_cfg, round_idx, ids)
        if cfg.drift_period:
            prev_fn = lambda c, r: self._histograms(data_cfg, r, c)  # noqa: E731
        else:
            prev_fn = lambda c, r: hist  # noqa: E731
        return (
            ids,
            fog_mod.gather_cohort_sched(sched_state, ids, prev_fn),
            fog_mod.gather_rows(telemetry, ids),
            fog_mod.gather_rows(env["profiles"], ids),
            torch.index_select(env["data_sizes"], 0, ids),
            torch.index_select(env["malicious"], 0, ids),
            hist,
        )

    @torch.no_grad()
    def _round(self, env, params, sched_state, telemetry, round_idx: int,
               *, in_place: bool = False):
        """One synchronous FL round: a function of its arguments and of the
        provider's draws keyed by ``round_idx``. In population mode it runs
        at cohort size between a gather and a scatter of the cohort's rows
        of ``sched_state`` and ``telemetry``. The scatter is out of place
        unless ``in_place``: then it writes into the (M,) rows it was
        given, which only a loop that owns them (``run``, ``run_scanned``)
        asks for, as JAX donates its scan carry."""
        cfg = self.cfg
        data_cfg = dataclasses.replace(self.data_cfg, seed=env["data_seed"])

        with _phase("schedule"):
            ids = None
            if self._pop_mode:
                ids, sched, tel, profiles, data_sizes, malicious, hist = (
                    self._gather_cohort(env, sched_state, telemetry, data_cfg,
                                        round_idx)
                )
            else:
                sched, tel, profiles = sched_state, telemetry, env["profiles"]
                data_sizes, malicious = env["data_sizes"], env["malicious"]
                hist = self._histograms(data_cfg, round_idx)
            decision = schedule_round(sched, tel, hist, cfg.scheduler,
                                      self._sched_weights)
            mask = self._participation(decision, tel, round_idx)
        with _phase("local_sgd"):
            deltas, mask = self._local_deltas(
                data_cfg, params, round_idx, mask, malicious, ids
            )

        # --- DES: latency + energy (§IV.F, shared RoundCostModel) ----- #
        with _phase("costs"):
            workload, up_bytes, down_bytes = self._round_workload()
            warm = sched.warm
            if cfg.policy in ("fogfaas",):
                warm = torch.zeros_like(warm)  # naive platform: no keep-alive
            costs = self.cost_model.round_costs(
                profiles, mask, warm, workload, up_bytes, down_bytes,
                policy="fedfog" if cfg.policy in ("fedfog", "rcs", "vanilla")
                else "fogfaas",
            )
            counters = faults_inject.zero_counters(self.device)
            agg_mask, energy_j, round_ms = mask, costs.energy_j, costs.round_ms
            skip = None
            if self._faults_on:
                plan, deltas = self._plan_faults(round_idx, mask, warm, deltas, costs)
                agg_mask = plan.arrived  # Eq. 6 reweights over the arrivals
                energy_j = costs.energy_j * plan.attempts  # retries repay
                round_ms = plan.round_ms
                skip, counters = plan.skip, plan.counters

        with _phase("server"):
            new_params = self._apply_deltas(
                params, deltas, agg_mask, data_sizes, round_idx
            )
            if skip is not None:
                # Below quorum the round is skipped: the model carries over
                # bitwise (the discarded aggregate is never selected).
                new_params = tree.map(
                    lambda p, q: torch.where(skip, p, q), params, new_params
                )
        with _phase("telemetry"):
            new_sched = account_energy(decision.new_state, energy_j, cfg.scheduler)
            new_tel = step_telemetry(
                self._tel_cfg_cohort, tel, mask, energy_j, profiles,
                self.draws, round=round_idx,
            )
            if self._pop_mode:
                new_sched = fog_mod.scatter_cohort_sched(
                    sched_state, ids, new_sched, round_idx, in_place=in_place
                )
                new_tel = fog_mod.scatter_rows(telemetry, ids, new_tel,
                                               in_place=in_place)
        with _phase("eval"):
            acc = self._eval_accuracy(data_cfg, new_params, round_idx)
        metrics = {
            "accuracy": acc,
            "num_selected": torch.sum(mask.to(torch.int32)),
            "round_latency_ms": round_ms,
            "orchestration_ms": costs.orchestration_ms,
            "energy_j": torch.sum(energy_j),
            "cold_starts": costs.cold_starts,
            "mean_drift": torch.mean(decision.selection.drift),
            "mean_utility": torch.mean(decision.selection.utility),
            "mean_battery": torch.mean(new_tel.batt),
            **counters,
        }
        return new_params, new_sched, new_tel, metrics

    # ------------------------------------------------------------------ #
    def _finalize(self, history: dict[str, Any], rounds: int) -> dict[str, Any]:
        """Shared summary schema (``obs.history``), and the tap's tracker
        summary."""
        finalize_history(history, rounds=rounds)
        if self.tap is not None:
            self.tap.tracker.log_summary({**self.tap.const, **summary_metrics(history)})
        return history

    def run(self, rounds: int | None = None) -> dict[str, Any]:
        """Per-round loop (debug/streaming path): one metrics transfer to
        the host per round."""
        rounds = rounds or self.cfg.rounds
        self._ensure_state()
        history: dict[str, list] = {}
        params, sched, tel = self.params, self.sched_state, self.telemetry
        for r in range(rounds):
            params, sched, tel, metrics = self._round(
                self.env, params, sched, tel, r, in_place=True)
            row = {name: float(v) for name, v in metrics.items()}
            for name, v in row.items():
                history.setdefault(name, []).append(v)
            if self.tap is not None:
                self.tap.host_log(row, r)  # the scanned tap's rows, host-side
        self.params, self.sched_state, self.telemetry = params, sched, tel
        return self._finalize(history, rounds)

    def _scan_rounds(self, rounds: int):
        """``rounds`` rounds from the instance's state, which they advance;
        returns the metric names and their (rounds, K) float64 stack, still
        on the device (``run_scanned``'s body, and one seed of
        ``sim.sweep.run_sweep``)."""
        self._ensure_state()
        params, sched, tel = self.params, self.sched_state, self.telemetry
        per_round = []
        for r in range(rounds):
            params, sched, tel, metrics = self._round(
                self.env, params, sched, tel, r, in_place=True)
            per_round.append(metrics)
            if self.tap is not None:
                self.tap.emit(metrics, r)  # decides on the host; no copy unless due
        self.params, self.sched_state, self.telemetry = params, sched, tel
        names = list(per_round[0]) if per_round else []
        stacked = torch.stack(
            [torch.stack([m[k].to(torch.float64) for k in names]) for m in per_round]
        ) if per_round else torch.zeros((0, 0), dtype=torch.float64)
        return names, stacked

    def run_scanned(self, rounds: int | None = None) -> dict[str, Any]:
        """All rounds with the per-round metrics stacked on the device and
        transferred to the host once at the end. Same round function and
        draws as ``run()``, so the histories agree."""
        rounds = int(rounds or self.cfg.rounds)
        names, stacked = self._scan_rounds(rounds)
        host = stacked.cpu().tolist()  # the single device -> host transfer
        history = {k: [row[i] for row in host] for i, k in enumerate(names)}
        return self._finalize(history, rounds)

    def aot_scanned(self, rounds: int | None = None) -> "ScannedProgram":
        """The scanned run as a program that a same-shape peer can run
        (``run_scanned_with``). The JAX package compiles the scan here; the
        port runs eagerly and compiles nothing, so the program records
        what the compiled one would be bound to: the configuration (the
        sweep's structural remainder and numeric values, the seed left
        out), the round count and the device."""
        if self.tap is not None:
            raise ValueError(
                "aot_scanned() does not support metric taps; build this "
                "simulator with tap=None (taps stream via run_scanned())"
            )
        return ScannedProgram(_program_key(self.cfg), int(rounds or self.cfg.rounds),
                              str(self.device))

    def run_scanned_with(self, program: "ScannedProgram",
                         rounds: int | None = None) -> dict[str, Any]:
        """``run_scanned`` through a program from ``aot_scanned`` (this
        instance's or a same-shape peer's): the same rounds on this
        instance's state, so the history equals its ``run_scanned()``.
        Raises ``ValueError`` for a program made for another configuration,
        device or round count."""
        rounds = int(rounds or program.rounds)
        mine = (_program_key(self.cfg), rounds, str(self.device))
        theirs = (program.config, program.rounds, program.device)
        for what, a, b in zip(("configuration", "round count", "device"), mine, theirs):
            if a != b:
                raise ValueError(
                    f"the program was made for another {what} ({b!r}, not {a!r})")
        return self.run_scanned(rounds)


@dataclasses.dataclass(frozen=True)
class ScannedProgram:
    """What ``aot_scanned`` returns: the structural configuration with its
    numeric values (``sim.sweep._factor_sim`` of the configuration at seed
    0), the round count and the device."""

    config: tuple
    rounds: int
    device: str


def _program_key(cfg: SimulatorConfig) -> tuple:
    from repro_torch.sim.sweep import _factor_sim

    struct, num = _factor_sim(dataclasses.replace(cfg, seed=0))
    return struct, tuple(sorted(num.items()))
