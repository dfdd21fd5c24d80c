"""Config-grid × seed-batch sweeps over either engine (port of
``repro/sim/sweep.py``).

The paper's tables are multi-seed, multi-config sweeps. ``run_sweep``
runs a grid of configuration overrides (``axes``, a cartesian product,
or ``cases``, an explicit list) over a batch of seeds, on the scanned
synchronous engine (``engine="scan"``) or the event-driven one
(``engine="async"``), and returns ``(G, S, R)`` float64 histories.

Configurations split into *structural* fields (task, policy, client
count, shapes, flags: in the JAX package they change the traced program)
and *numeric* ones (learning rates, thresholds, ``top_k``, staleness
exponents, straggler sigma, churn and fault rates), as ``_factor_sim`` /
``_factor_async`` define them. Grid points that share a structural
signature form a group; a grouped point runs the configuration rebuilt
from its signature and numeric values (``_apply_numeric``), the
ungrouped oracle (``group=False``) the concrete one, and the two agree
bit for bit.

The port runs eagerly: each (point, seed) is ``init_state(seed)`` and
the engine's rounds (or events) on the device, with the per-round
metrics stacked there and copied to the host once per group. Seed s of
a point equals ``FedFogSimulator(replace(cfg, seed=s)).run_scanned()``
(or the standalone ``AsyncFedFogSimulator.run()``) bit for bit. Nothing
is compiled, so there is no program cache, in the process or on disk
(``REPRO_COMPILE_CACHE_DIR`` has nothing to hold here, and the JAX
package's ``cache`` option has no counterpart), and ``timings`` reports
``trace_s``, ``compile_s``, ``load_s``, ``n_compiles``, ``cache_hits``
and ``disk_hits`` as 0. Seeds and numeric points run one after another: the
JAX package's ``vmap`` over them, a batch axis here, is later work
(ROADMAP's performance queue), as is sharding seeds over several cards
(``devices`` > 1, ROADMAP queue 1, item 11(b)).

Typical use::

    from repro_torch.sim import run_sweep
    res = run_sweep(SimulatorConfig(rounds=50), seeds=range(8),
                    axes={"policy": ["fedfog", "rcs"], "lr": [0.01, 0.05]})
    mean, ci = res.mean_ci("accuracy")      # (G, R) curves
    finals = res.final("accuracy")          # (G, S)
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.sim.faults import config as faults_config


def _grid(axes: Mapping[str, Sequence[Any]] | None,
          cases: Sequence[Mapping[str, Any]] | None) -> list[dict[str, Any]]:
    """Grid points as config-override dicts: ``cases`` wins over ``axes``
    (a cartesian product); both empty give one unmodified point."""
    if cases:
        return [dict(c) for c in cases]
    if not axes:
        return [{}]
    names = list(axes)
    return [dict(zip(names, combo))
            for combo in itertools.product(*(axes[n] for n in names))]


# --------------------------------------------------------------------- #
# structural / numeric config factoring
# --------------------------------------------------------------------- #
# Scalar fields that are data, not structure. Fields whose zero / None
# value gates a branch are liftable only while the gate is on.
_SIM_NUMERIC = (
    "lr", "server_lr", "top_k", "dp_sigma",
    "attack_noise_scale", "attack_replacement_scale", "trim_fraction",
)
_SCHED_NUMERIC = ("theta_h", "theta_e", "theta_d")
_ASYNC_NUMERIC = (
    "staleness_exponent", "dispatch_interval_ms", "straggler_sigma",
    "buffer_k", "horizon_ms",
)
_GATED_POSITIVE = frozenset({"dp_sigma", "straggler_sigma"})
# Written into the structural remainder in place of a lifted field, so
# that "lifted" differs from every concrete value in the signature.
_LIFTED = "<lifted>"


def _liftable(name: str, value: Any) -> bool:
    if value is None or isinstance(value, bool):
        return False  # None-ness and flags are structural
    if not isinstance(value, (int, float)):
        return False
    if name in _GATED_POSITIVE and value <= 0:
        return False  # gate off: the branch is not taken; keep it concrete
    return True


def _factor_sim(cfg):
    """Split a ``SimulatorConfig`` into (structural remainder, numeric
    values). Numeric keys are field names, ``scheduler.<field>`` for the
    Eq. 3 thresholds and ``faults.<field>`` for an active fault layer's
    rates and scales. Two configs that differ only in numeric values have
    equal remainders."""
    num: dict[str, float] = {}
    repl: dict[str, Any] = {}
    for f in _SIM_NUMERIC:
        v = getattr(cfg, f)
        if _liftable(f, v):
            num[f] = v
            repl[f] = _LIFTED
    sched = cfg.scheduler
    for f in _SCHED_NUMERIC:
        num[f"scheduler.{f}"] = float(getattr(sched, f))
    repl["scheduler"] = dataclasses.replace(sched, **{f: _LIFTED for f in _SCHED_NUMERIC})
    fc = cfg.faults
    if fc is not None and faults_config.active(fc):
        # The gate itself is structural; once on, every rate and scale
        # (exact zeros included) is data.
        fc_repl: dict[str, Any] = {}
        for f in faults_config.RATE_FIELDS + faults_config.SCALE_FIELDS:
            v = getattr(fc, f)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                num[f"faults.{f}"] = float(v)
                fc_repl[f] = _LIFTED
        d = fc.deadline_ms
        if d is not None and isinstance(d, (int, float)):
            num["faults.deadline_ms"] = float(d)  # None-ness is structural
            fc_repl["deadline_ms"] = _LIFTED
        repl["faults"] = dataclasses.replace(fc, **fc_repl)
    return dataclasses.replace(cfg, **repl), num


def _factor_async(acfg):
    """``_factor_sim`` for an ``AsyncConfig``: ``async.<field>`` and
    ``churn.<field>`` keys (zero churn rates stay structural: they take
    the identity shortcut)."""
    num: dict[str, float] = {}
    repl: dict[str, Any] = {}
    for f in _ASYNC_NUMERIC:
        v = getattr(acfg, f)
        if _liftable(f, v):
            num[f"async.{f}"] = v
            repl[f] = _LIFTED
    churn = acfg.churn
    ch_repl = {}
    for f in ("arrival_rate", "departure_rate", "death_batt"):
        v = getattr(churn, f)
        if f != "death_batt" and v == 0.0:
            continue
        if _liftable(f, v):
            num[f"churn.{f}"] = v
            ch_repl[f] = _LIFTED
    if ch_repl:
        repl["churn"] = dataclasses.replace(churn, **ch_repl)
    return dataclasses.replace(acfg, **repl), num


def _apply_numeric(cfg, num: Mapping[str, Any]):
    """Re-inject numeric values into a structural ``SimulatorConfig``."""
    plain = {k: v for k, v in num.items() if "." not in k}
    sched_over = {k.split(".", 1)[1]: v for k, v in num.items()
                  if k.startswith("scheduler.")}
    if sched_over:
        plain["scheduler"] = dataclasses.replace(cfg.scheduler, **sched_over)
    faults_over = {k.split(".", 1)[1]: v for k, v in num.items()
                   if k.startswith("faults.")}
    if faults_over:
        plain["faults"] = dataclasses.replace(cfg.faults, **faults_over)
    return dataclasses.replace(cfg, **plain)


def _apply_async_numeric(acfg, num: Mapping[str, Any]):
    """Re-inject numeric values into a structural ``AsyncConfig``."""
    plain = {k.split(".", 1)[1]: v for k, v in num.items() if k.startswith("async.")}
    churn_over = {k.split(".", 1)[1]: v for k, v in num.items()
                  if k.startswith("churn.")}
    if churn_over:
        plain["churn"] = dataclasses.replace(acfg.churn, **churn_over)
    return dataclasses.replace(acfg, **plain) if plain else acfg


# --------------------------------------------------------------------- #
# one (point, seed)
# --------------------------------------------------------------------- #
def _seed_metrics(engine, cfg, acfg, seed: int, rounds: int, device, draws):
    """One seed's metric histories, on the device: {name: (R,) float64}
    for the scanned engine, the padded flush channels and scalar counters
    (``metrics_for_seed``) for the async one. ``draws`` maps a seed to a
    draw provider (None: the production provider)."""
    cfg = dataclasses.replace(cfg, seed=int(seed))
    provider = None if draws is None else draws(int(seed))
    if engine == "async":
        from repro_torch.sim.events.engine import AsyncFedFogSimulator

        sim = AsyncFedFogSimulator(cfg, acfg, device=device, draws=provider)
        return {k: v.to(torch.float64) for k, v in sim.metrics_for_seed(seed).items()}
    from repro_torch.fl.simulator import FedFogSimulator

    sim = FedFogSimulator(cfg, device=device, draws=provider)
    names, stacked = sim._scan_rounds(rounds)
    return {k: stacked[:, i] for i, k in enumerate(names)}


def _to_host(per_run: list[dict[str, torch.Tensor]]) -> list[dict[str, np.ndarray]]:
    """One device -> host copy of many runs' metric dicts."""
    if not per_run:
        return []
    names = list(per_run[0])
    flat = torch.cat([m[k].reshape(-1) for m in per_run for k in names]).cpu().numpy()
    out, off = [], 0
    for m in per_run:
        row = {}
        for k in names:
            size = m[k].numel()
            row[k] = flat[off:off + size].reshape(tuple(m[k].shape))
            off += size
        out.append(row)
    return out


@dataclasses.dataclass
class SweepResult:
    """Stacked histories of a config-grid × seed-batch sweep."""

    configs: list[dict[str, Any]]  # G override dicts (grid points)
    seeds: np.ndarray  # (S,)
    rounds: int
    history: dict[str, np.ndarray]  # each (G, S, R)

    def metric(self, name: str) -> np.ndarray:
        """(G, S, R) round-by-round history of one metric."""
        return self.history[name]

    def final(self, name: str) -> np.ndarray:
        """(G, S) last-round value of a metric; with a ``valid`` channel
        (async histories, padded to the flush capacity) the last valid
        flush of each run."""
        h = self.history[name]
        if "valid" in self.history:
            v = self.history["valid"] > 0
            idx = np.where(v.any(axis=-1),
                           v.shape[-1] - 1 - np.argmax(v[..., ::-1], axis=-1), 0)
            return np.take_along_axis(h, idx[..., None], axis=-1)[..., 0]
        return h[..., -1]

    def mean_ci(self, name: str, z: float = 1.96) -> tuple[np.ndarray, np.ndarray]:
        """Across-seed mean and z·SEM half-width, each (G, R) (sample std,
        ddof=1; NaN with one seed). For round-aligned (sync) histories."""
        h = self.history[name]
        mean = h.mean(axis=1)
        s = h.shape[1]
        if s < 2:
            return mean, np.full_like(mean, np.nan)
        return mean, z * h.std(axis=1, ddof=1) / np.sqrt(s)

    def mean_std(self, name: str, reduce: str = "final") -> tuple[np.ndarray, np.ndarray]:
        """Across-seed mean / std of a per-run scalar, each (G,); ``reduce``
        is 'final', 'sum', 'mean' or 'max' over the round axis."""
        h = self.history[name]
        per_run = {"final": h[..., -1], "sum": h.sum(axis=-1), "mean": h.mean(axis=-1),
                   "max": h.max(axis=-1)}[reduce]
        return per_run.mean(axis=1), per_run.std(axis=1)

    def stats(self, g: int = 0) -> dict[str, np.ndarray]:
        """Per-seed summary of grid point ``g``, each (S,)."""
        h = {k: v[g] for k, v in self.history.items()}
        return {
            "final_accuracy": self.final("accuracy")[g],
            "peak_accuracy": h["accuracy"].max(axis=-1),
            "total_energy_j": h["energy_j"].sum(axis=-1),
            "mean_latency_ms": h["round_latency_ms"].mean(axis=-1),
            "total_cold_starts": h["cold_starts"].sum(axis=-1),
        }


def run_sweep(
    cfg,
    seeds: Iterable[int],
    axes: Mapping[str, Sequence[Any]] | None = None,
    cases: Sequence[Mapping[str, Any]] | None = None,
    rounds: int | None = None,
    devices: int | Sequence[Any] | None = None,
    engine: str = "scan",
    async_cfg: Any | None = None,
    group: bool = True,
    timings: dict | None = None,
    tracker: Any | None = None,
    *,
    device: str | torch.device | None = None,
    draws: Callable[[int], Any] | None = None,
) -> SweepResult:
    """Run a (config grid) × (seed batch) × (rounds) sweep.

    Args:
      cfg: base ``SimulatorConfig``; ``cfg.seed`` gives way to ``seeds``.
      seeds: the seed batch.
      axes / cases: the grid (see ``_grid``). With ``engine="async"``,
        override keys naming ``AsyncConfig`` fields go to the async config.
      rounds: overrides ``cfg.rounds``; for ``engine="async"`` the dispatch
        budget, which otherwise is ``async_cfg.max_dispatches``, else
        ``cfg.rounds``.
      devices: None, 0 or 1; more cards raise ``NotImplementedError``.
      engine: ``"scan"`` (synchronous rounds) or ``"async"`` (per-flush
        histories padded to the flush capacity, with a ``valid`` channel).
      async_cfg: base ``AsyncConfig`` for ``engine="async"``.
      group: group points by structural signature (``False``: the
        per-point oracle).
      timings: optional dict, accumulating ``exec_s`` and ``n_groups``
        (and the JAX package's compile fields as 0).
      tracker: optional ``obs.Tracker``: one ``sweep_group`` row per group
        (``sweep_point`` per point ungrouped) and a closing summary.
      device: where the simulators run (default CUDA; "cpu" on request).
      draws: seed -> draw provider (default: the production provider).
    """
    rounds_arg = rounds
    rounds = int(rounds or cfg.rounds)
    seeds_list = [int(s) for s in seeds]
    if not seeds_list:
        raise ValueError("seeds must be a non-empty 1-D collection of ints")
    if engine not in ("scan", "async"):
        raise ValueError(f"unknown engine {engine!r}")
    n_devices = devices if isinstance(devices, int) else len(devices or ())
    if n_devices > 1:
        raise NotImplementedError(
            "sharding a sweep's seeds over several cards is not ported yet: "
            "see ROADMAP.md, queue 1, item 11(b)")
    grid = _grid(axes, cases)
    if tracker is not None and timings is None:
        timings = {}
    if timings is not None:
        for k in ("trace_s", "compile_s", "exec_s", "load_s"):
            timings.setdefault(k, 0.0)
        for k in ("n_compiles", "cache_hits", "disk_hits", "n_groups"):
            timings.setdefault(k, 0)

    base_a, a_fields = None, set()
    if engine == "async":
        from repro_torch.sim.events.engine import AsyncConfig

        a_fields = {f.name for f in dataclasses.fields(AsyncConfig)}
        base_a = async_cfg or AsyncConfig()

    def canonical(overrides):
        cfg_i = dataclasses.replace(
            cfg, **{k: v for k, v in overrides.items() if k not in a_fields})
        if engine != "async":
            return cfg_i, None
        a_ov = {k: v for k, v in overrides.items() if k in a_fields}
        # Dispatch budget: the rounds= argument, else the async config's
        # own max_dispatches, else cfg.rounds.
        budget = int(rounds_arg) if rounds_arg else int(base_a.max_dispatches or cfg.rounds)
        return cfg_i, dataclasses.replace(base_a, **{"max_dispatches": budget, **a_ov})

    def run_point(cfg_p, acfg_p):
        return [_seed_metrics(engine, cfg_p, acfg_p, s, rounds, device, draws)
                for s in seeds_list]

    per_g: list[Any] = [None] * len(grid)
    if group:
        groups: dict[Any, dict[str, Any]] = {}
        for g, overrides in enumerate(grid):
            cfg_i, acfg_i = canonical(overrides)
            struct_cfg, num = _factor_sim(cfg_i)
            struct_acfg = None
            if engine == "async":
                struct_acfg, a_num = _factor_async(acfg_i)
                num.update(a_num)
            sig = (struct_cfg, struct_acfg, tuple(sorted(num)), rounds, engine)
            entry = groups.setdefault(
                sig, {"points": [], "members": [], "struct": (struct_cfg, struct_acfg)})
            entry["points"].append(num)
            entry["members"].append(g)
        for gi, entry in enumerate(groups.values()):
            struct_cfg, struct_acfg = entry["struct"]
            t0 = time.perf_counter()
            runs = []
            for num in entry["points"]:
                acfg_p = (None if struct_acfg is None
                          else _apply_async_numeric(struct_acfg, num))
                runs += run_point(_apply_numeric(struct_cfg, num), acfg_p)
            host = _to_host(runs)  # one copy per group
            g_exec = time.perf_counter() - t0
            if timings is not None:
                timings["exec_s"] += g_exec
            if tracker is not None:
                tracker.log({
                    "event": "sweep_group", "engine": engine,
                    "n_members": len(entry["members"]), "n_seeds": len(seeds_list),
                    "rounds": rounds, "cache_hit": False, "disk_hit": False,
                    "trace_s": 0.0, "compile_s": 0.0, "load_s": 0.0, "exec_s": g_exec,
                }, step=gi)
            s = len(seeds_list)
            for j, g in enumerate(entry["members"]):
                per_g[g] = host[j * s:(j + 1) * s]
        if timings is not None:
            timings["n_groups"] += len(groups)
    else:
        for g, overrides in enumerate(grid):
            t0 = time.perf_counter()
            per_g[g] = _to_host(run_point(*canonical(overrides)))  # one copy a point
            wall = time.perf_counter() - t0
            if timings is not None:
                timings["exec_s"] += wall
            if tracker is not None:
                tracker.log({
                    "event": "sweep_point", "engine": engine,
                    "overrides": repr(overrides), "n_seeds": len(seeds_list),
                    "rounds": rounds, "wall_s": wall,
                }, step=g)

    if engine == "async":
        # Overflow corrupts the flush histories: raise, as run() does.
        for overrides, runs in zip(grid, per_g):
            dropped = np.asarray([r["queue_dropped"] for r in runs])
            if dropped.any():
                raise RuntimeError(
                    f"async event queue overflowed for grid point {overrides} "
                    f"(max {int(dropped.max())} dropped); raise "
                    "AsyncConfig.queue_capacity")
    history = {
        name: np.stack([np.stack([np.asarray(r[name], np.float64) for r in runs])
                        for runs in per_g])
        for name in per_g[0][0]
    }
    if tracker is not None:
        tracker.log_summary({
            "event": "sweep", "engine": engine, "n_points": len(grid),
            "n_seeds": len(seeds_list), "rounds": rounds, "grouped": group,
            **(timings or {}),
        })
    return SweepResult(configs=grid, seeds=np.asarray(seeds_list), rounds=rounds,
                       history=history)
