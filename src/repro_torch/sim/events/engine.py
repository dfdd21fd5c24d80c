"""``AsyncFedFogSimulator`` — event-driven asynchronous FL on a virtual
clock (port of ``repro/sim/events/engine.py``).

Where ``FedFogSimulator`` runs synchronous rounds, this engine advances a
continuous virtual clock through a fixed-capacity event queue
(``queue.py``) that lives on the device:

  * DISPATCH events admit clients through the same ``schedule_round``
    gating and policy participation as the sync engine, compute their
    local updates against the current global model (the shared
    ``FedFogSimulator._local_deltas``), and schedule one COMPLETE event per
    admitted client at an arrival time from the shared ``RoundCostModel``
    plus an optional lognormal straggler tail.
  * COMPLETE events move the client's update into the server buffer. The
    server flushes the buffer (the staleness-discounted Eq. 6 of
    ``staleness.py``; with ``use_pallas_agg`` K3 on its staleness route,
    one K4 per fog, or K3's ``robust_kernel`` under median / trimmed mean)
    when it holds ``buffer_k`` updates, or when nothing is in flight.
  * Churn (``churn.py``) takes clients offline between events; a client
    that leaves mid-flight never reports (its COMPLETE is cancelled).
  * With ``faults``, RETRY events relaunch failed invocations after
    backoff and DEADLINE events shed overdue work under a quorum rule.

The loop is an eager Python loop over **coalesced steps**
(``AsyncConfig.coalesce``, on by default): each step pops either one
non-COMPLETE event, or the run of COMPLETE events before the next one in
pop order (capped at the ``buffer_k`` boundary, so no flush could have
fired inside it) as one masked buffer fill. The JAX package's
``lax.while_loop`` / ``lax.switch`` / ``lax.cond`` become host decisions:
a step copies the first event's validity, kind and client (the branch;
an empty queue ends the loop) to the host in one small copy, runs that
branch, and reads its ``want_flush`` when the branch can flush: at most
two host synchronisations a step. Dispatch,
flush and use counts live on the host as Python ints, so every draw is
keyed without a further copy. ``coalesce=False`` keeps one pop a step,
the oracle that the coalesced loop equals bit for bit.

Sync recovery: with ``dispatch_mode="on_flush"``, no churn, no straggler
tail and ``buffer_k=None`` every dispatch behaves as one synchronous round
on the same keyed draws (``random.flush_context``), and the history
matches ``run_scanned()``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.core import aggregation as agg_mod
from repro_torch.core.scheduler import account_energy, schedule_round
from repro_torch.core.types import SchedulerState, static_on
from repro_torch.data.telemetry import step_telemetry
from repro_torch.device import scalar
from repro_torch.fl import fog as fog_mod
from repro_torch.fl.fuse import fuse_clients, fuse_vector, fused_gaussian_noise
from repro_torch.fl.simulator import FedFogSimulator, SimulatorConfig
from repro_torch.obs.history import (
    assemble_async_history,
    finalize_history,
    summary_metrics,
)
from repro_torch.sim.events.churn import (
    ChurnConfig,
    available_mask,
    init_online,
    step_churn,
)
from repro_torch.sim.events.queue import (
    KIND_COMPLETE,
    KIND_DEADLINE,
    KIND_DISPATCH,
    KIND_RETRY,
    cancel_events,
    make_queue,
    pop_batch,
    pop_event,
    pop_order_rank,
    push_event,
    push_events,
)
from repro_torch.sim.events.staleness import async_aggregate
from repro_torch.sim.faults import config as faults_config
from repro_torch.sim.faults import inject as faults_inject
from repro_torch.sim.faults.inject import _f32

Array = torch.Tensor

_FLUSH_METRICS = (
    "t_ms", "accuracy", "num_aggregated", "mean_staleness", "energy_j",
    "update_latency_ms", "cold_starts",
)
_DISPATCH_METRICS = ("t_ms", "num_admitted", "num_available", "cold_starts")
_FAULT_COUNTERS = (
    "fault_failures", "fault_retries", "fault_terminal", "fault_lost_deadline",
    "fault_corrupt", "fault_skipped", "fog_outages",
)


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Event-engine knobs, orthogonal to the shared ``SimulatorConfig``.

    ``buffer_k``: server buffer size K. ``1`` aggregates every arriving
    update at once (FedAsync); ``K>1`` waits for K updates (FedBuff);
    ``None`` disables count-triggered flushes, which with
    ``flush_on_idle`` means "flush when the cohort drains", the
    synchronous-equivalent configuration.

    ``dispatch_mode``: ``"on_flush"`` schedules the next DISPATCH when a
    flush happens (sequential cohorts); ``"interval"`` dispatches on a
    fixed virtual cadence, so cohorts overlap and staleness accrues.
    """

    max_dispatches: int | None = None  # default: SimulatorConfig.rounds
    dispatch_mode: str = "on_flush"  # "on_flush" | "interval"
    dispatch_interval_ms: float = 5000.0
    buffer_k: int | None = None  # 1=FedAsync, K>1=FedBuff, None=cohort
    flush_on_idle: bool = True  # flush leftovers when nothing is in flight
    staleness_exponent: float = 0.5  # a in (1+s)^-a; 0 = no discount
    straggler_sigma: float = 0.0  # lognormal tail on per-client latency
    horizon_ms: float | None = None  # stop dispatching past this time
    churn: ChurnConfig = dataclasses.field(default_factory=ChurnConfig)
    queue_capacity: int | None = None  # default: num_clients + 8
    max_events: int | None = None  # default: max_dispatches*(N+1)+2
    coalesce: bool = True  # batched event stepping (False = one pop/step)

    @classmethod
    def fedasync(cls, **kw) -> "AsyncConfig":
        """Immediate staleness-weighted application of every update."""
        kw.setdefault("buffer_k", 1)
        kw.setdefault("dispatch_mode", "interval")
        return cls(**kw)

    @classmethod
    def fedbuff(cls, k: int = 8, **kw) -> "AsyncConfig":
        """Buffered aggregation: flush every ``k`` arrived updates."""
        kw.setdefault("buffer_k", k)
        kw.setdefault("dispatch_mode", "interval")
        return cls(**kw)


class AsyncState(NamedTuple):
    """The event loop's state. Tensors live on the simulator's device;
    the counts the host decides on (dispatches, flushes, the model
    version and the flush keys' dispatch and use count) are Python ints,
    which the JAX package carries as arrays and keys as PRNG keys."""

    queue: Any
    t_ms: Array  # () virtual clock
    env: Any  # profiles / data_sizes / malicious / data_seed
    params: Any
    sched: Any  # SchedulerState (PopulationSchedulerState in population mode)
    tel: Any  # ClientTelemetry
    online: Array  # (N,) churn presence
    version: int  # global model version (increments per flush)
    dispatch_idx: int  # dispatches so far
    flush_idx: int  # flushes so far
    completions: Array  # () updates arrived so far
    lost_inflight: Array  # () in-flight updates killed by churn
    busy: Array  # (N,) update in flight
    buf: Array  # (N,) completed, awaiting aggregation
    pending: Array  # (N, P) fused delta buffer stored at dispatch time
    pend_version: Array  # (N,) model version the delta was computed at
    pend_energy: Array  # (N,) Joules of the in-flight update
    pend_t: Array  # (N,) dispatch time of the in-flight update
    last_disp_t: Array  # () time of the latest dispatch
    last_cold: Array  # () cold starts accrued since the last flush
    key_round: int  # dispatch whose dp / telemetry / eval draws a flush takes
    key_uses: int  # flushes that already took them
    m_flush: Any  # dict of (max_flushes,) metric tensors
    m_dispatch: Any  # dict of (max_dispatches,) metric tensors
    # Population mode (population > num_clients): the N event slots are
    # leased to virtual clients. owner[i] is the population id whose
    # in-flight or buffered update occupies slot i, pend_sizes[i] its |D|
    # weight, captured at admission. Dense mode: owner = arange, sizes =
    # the registry's.
    owner: Array  # (N,) int64 population id leasing each slot
    pend_sizes: Array  # (N,) f32 |D| of the slot's in-flight update
    # Fault layer (sim.faults): zeros while the fault gate is off.
    pend_ms: Array  # (N,) f32 one attempt's latency (retries repay it)
    pend_fkey: Array  # (N,) int32 dispatch that admitted the retry chain
    pend_attempts: Array  # (N,) f32 attempts launched (energy multiplier)
    last_admitted: Array  # () f32 admitted count of the latest dispatch
    fault_failures: Array  # () i32 failed invocation attempts
    fault_retries: Array  # () i32 retry relaunches
    fault_terminal: Array  # () i32 clients that exhausted the retry cap
    fault_lost_deadline: Array  # () i32 in-flight work shed by a deadline
    fault_corrupt: Array  # () i32 corrupted-but-arrived payloads
    fault_skipped: Array  # () i32 below-quorum rounds skipped
    fog_outages: Array  # () i32 fog-node dark windows


class _Pop(NamedTuple):
    """An event known to the host: its kind and the fields a retry keys
    its draws by; the event itself stays on the device."""

    kind: int
    client: int  # clipped to [0, N)
    attempt: int  # max(int(payload), 1): a RETRY's attempt index
    fkey: int  # pend_fkey of the client: its retry chain's dispatch


class AsyncFedFogSimulator:
    """Event-driven engine composing (and sharing code with) the sync one.

    ``self.sim`` is a ``FedFogSimulator(defer_state=True)`` on the same
    device and draw provider, providing ``init_state`` / ``_histograms``
    / ``_participation`` / ``_local_deltas`` / ``_eval_accuracy`` and the
    shared ``RoundCostModel``; this class adds the event mechanics.
    """

    def __init__(
        self,
        cfg: SimulatorConfig,
        async_cfg: AsyncConfig | None = None,
        *,
        device: str | torch.device | None = None,
        draws=None,
        tap=None,
    ):
        """``device`` defaults to CUDA (raises without one); pass "cpu"
        to run on the CPU. ``draws`` is the draw provider (by default the
        production one seeded from ``cfg.seed``). ``tap`` (an
        ``obs.MetricTap``) streams every k-th flush's metrics; None or a
        disabled tap changes nothing."""
        self.cfg = cfg
        self.acfg = async_cfg or AsyncConfig()
        self.tap = tap if (tap is not None and tap.enabled) else None
        if self.acfg.dispatch_mode not in ("on_flush", "interval"):
            raise ValueError(f"unknown dispatch_mode {self.acfg.dispatch_mode!r}")
        self.sim = FedFogSimulator(cfg, device=device, draws=draws, defer_state=True)
        self.device = self.sim.device
        n = cfg.num_clients
        self.max_dispatches = int(self.acfg.max_dispatches or cfg.rounds)
        # The fault gate is the sync simulator's; the async engine realizes
        # faults event by event (RETRY relaunches, DEADLINE sheds).
        self._faults_on = self.sim._faults_on
        deadline_on = self._faults_on and cfg.faults.deadline_ms is not None
        if self._faults_on:
            retries = int(cfg.faults.max_retries)
            # Outstanding events: <= 1 per client, 1 DISPATCH and a backlog
            # of <= D deadlines not yet fired.
            default_cap = n + 8 + (self.max_dispatches if deadline_on else 0)
            default_events = self.max_dispatches * (n * (retries + 2) + 2) + 2
        else:
            default_cap = n + 8
            default_events = self.max_dispatches * (n + 1) + 2
        self.capacity = int(self.acfg.queue_capacity or default_cap)
        self.max_events = int(self.acfg.max_events or default_events)
        self.max_flushes = self.max_events  # flushes <= dispatches + completions
        self.steps = 0  # loop steps of the latest run (coalesced or single-pop)

    # ------------------------------------------------------------------ #
    def init_state(self, seed: int) -> AsyncState:
        """The initial state for ``seed`` (the provider's seed)."""
        cfg, n, dev = self.cfg, self.cfg.num_clients, self.device
        env, params, sched, tel = self.sim.init_state(seed)
        online = init_online(self.acfg.churn, n, self.sim.draws)
        queue = push_event(make_queue(self.capacity, dev), 0.0, -1, KIND_DISPATCH)
        # The in-flight deltas are one fused (N, P) float32 buffer, fed
        # straight to the server pass at a flush.
        p = sum(x.numel() for x in tree.leaves(params))
        zf = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        zi = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)  # noqa: E731
        owner = torch.arange(n, device=dev)
        return AsyncState(
            queue=queue,
            t_ms=zf(),
            env=env,
            params=params,
            sched=sched,
            tel=tel,
            online=online,
            version=0,
            dispatch_idx=0,
            flush_idx=0,
            completions=zi(),
            lost_inflight=zi(),
            busy=torch.zeros((n,), dtype=torch.bool, device=dev),
            buf=torch.zeros((n,), dtype=torch.bool, device=dev),
            pending=zf(n, p),
            pend_version=zi(n),
            pend_energy=zf(n),
            pend_t=zf(n),
            last_disp_t=zf(),
            last_cold=zi(),
            key_round=0,
            key_uses=0,
            m_flush={k: zf(self.max_flushes) for k in _FLUSH_METRICS + ("valid",)},
            m_dispatch={k: zf(self.max_dispatches) for k in _DISPATCH_METRICS},
            owner=owner,
            pend_sizes=torch.index_select(env["data_sizes"], 0, owner).to(torch.float32),
            pend_ms=zf(n),
            pend_fkey=zi(n),
            pend_attempts=zf(n),
            last_admitted=zf(),
            **{k: zi() for k in _FAULT_COUNTERS},
        )

    # ------------------------------------------------------------------ #
    def _data_cfg(self, state):
        return dataclasses.replace(self.sim.data_cfg, seed=state.env["data_seed"])

    def _more_dispatches(self, state, t_next):
        """Whether another DISPATCH may be scheduled at ``t_next``: a bool,
        or a () bool tensor under a horizon."""
        if state.dispatch_idx >= self.max_dispatches:
            return False
        if self.acfg.horizon_ms is not None:
            return t_next <= self.acfg.horizon_ms
        return True

    def _push_next_dispatch(self, state, queue, enable):
        """on_flush mode: the next DISPATCH at the current time, unless one
        is queued already (possible under buffer_k flushes) or the budget
        or horizon is spent."""
        more = self._more_dispatches(state, state.t_ms)
        if more is False or enable is False:
            return queue
        queued = torch.any(queue.valid & (queue.kind == KIND_DISPATCH))
        gate = ~queued if more is True else more & ~queued
        return push_event(queue, state.t_ms, -1, KIND_DISPATCH,
                          enable=gate if enable is True else gate & enable)

    def _flush(self, state: AsyncState) -> AsyncState:
        """Aggregate the buffer into the global model (one server step).

        The tail of the sync round: staleness-generalized Eq. 6, optional
        DP noise, server step, Eq. 10 energy accounting, telemetry step
        and eval, drawing with the latest dispatch's context (its own for
        the first flush after it, its use count folded in after), so the
        cohort configuration reproduces ``_round``.
        """
        cfg, acfg, sim = self.cfg, self.acfg, self.sim
        buf = state.buf
        staleness = (state.version - state.pend_version).to(torch.float32)
        d, uses = state.key_round, state.key_uses
        base_flat, unfuse_vec = fuse_vector(state.params)
        noise = None
        if static_on(cfg.dp_sigma):
            noise = fused_gaussian_noise(
                sim.draws, cfg.dp_sigma * (cfg.clip_norm or 1.0),
                tuple(x.numel() for x in tree.leaves(state.params)),
                round=d, uses=uses,
            )
        # Population mode aggregates with the |D| weights captured at
        # admission, so the flush never reads the (M,) registry for
        # model-sized math.
        pop_mode = sim._pop_mode
        sizes_vec = state.pend_sizes if pop_mode else state.env["data_sizes"]
        # Robust aggregators are unweighted medians / means over the live
        # buffer; staleness discounting does not compose with them.
        robust = cfg.aggregator in ("median", "trimmed")
        if cfg.use_pallas_agg:
            from repro_torch.kernels.delta_pipeline import delta_pipeline_apply

            if cfg.fog_nodes > 1:
                new_flat = fog_mod.fog_pipeline_apply(
                    state.pending, base_flat, buf, sizes_vec, lr=cfg.server_lr,
                    staleness=staleness,
                    staleness_exponent=acfg.staleness_exponent,
                    dp_noise=noise, fog_nodes=cfg.fog_nodes,
                )
            else:
                new_flat = delta_pipeline_apply(
                    state.pending, base_flat, buf, sizes_vec, lr=cfg.server_lr,
                    staleness=None if robust else staleness,
                    staleness_exponent=acfg.staleness_exponent,
                    dp_noise=noise, trim_fraction=cfg.trim_fraction,
                    aggregator=cfg.aggregator,
                )
        else:
            if cfg.aggregator == "median":
                agg = agg_mod.median_aggregate(state.pending, buf)
            elif cfg.aggregator == "trimmed":
                agg = agg_mod.trimmed_mean_aggregate(state.pending, buf,
                                                     cfg.trim_fraction)
            elif cfg.fog_nodes > 1:
                agg = fog_mod.fog_aggregate(state.pending, buf, sizes_vec,
                                            cfg.fog_nodes, staleness,
                                            acfg.staleness_exponent)
            else:
                agg = async_aggregate(state.pending, buf, sizes_vec, staleness,
                                      acfg.staleness_exponent)
            if noise is not None:
                agg = agg + noise
            new_flat = base_flat + cfg.server_lr * agg
        params = unfuse_vec(new_flat)
        energy = state.pend_energy * buf
        if self._faults_on:
            # Every launched attempt repays the invocation's energy.
            energy = energy * state.pend_attempts
        if pop_mode:
            # Gather the owners' registry rows, advance only the flushed
            # slots' rows, scatter back. Owners duplicated across slots
            # resolve last-writer-wins, as in the JAX package (rare at
            # population scale).
            owner, n = state.owner, cfg.num_clients
            take = lambda a: torch.index_select(a, 0, owner)  # noqa: E731
            srows = SchedulerState(
                prev_hist=torch.zeros((n, 1), device=self.device),  # not read
                theta_e=take(state.sched.theta_e), warm=take(state.sched.warm),
                last_used=take(state.sched.last_used),
                energy_spent=take(state.sched.energy_spent),
                round_index=state.sched.round_index,
            )
            srows2 = account_energy(srows, energy, cfg.scheduler)
            sched = dataclasses.replace(
                state.sched,
                theta_e=state.sched.theta_e.index_copy(
                    0, owner, torch.where(buf, srows2.theta_e, srows.theta_e)),
                energy_spent=state.sched.energy_spent.index_copy(
                    0, owner, torch.where(buf, srows2.energy_spent, srows.energy_spent)),
            )
            tel_rows = fog_mod.gather_rows(state.tel, owner)
            stepped = step_telemetry(
                sim._tel_cfg_cohort, tel_rows, buf, energy,
                fog_mod.gather_rows(state.env["profiles"], owner), sim.draws,
                round=d, uses=uses,
            )
            stepped = type(tel_rows)(**{
                f.name: torch.where(buf, getattr(stepped, f.name), getattr(tel_rows, f.name))
                for f in dataclasses.fields(tel_rows)})
            tel = fog_mod.scatter_rows(state.tel, owner, stepped)
        else:
            sched = account_energy(state.sched, energy, cfg.scheduler)
            tel = step_telemetry(sim.tel_cfg, state.tel, buf, energy,
                                 state.env["profiles"], sim.draws, round=d, uses=uses)
        acc = sim._eval_accuracy(self._data_cfg(state), params, d, uses)

        count = torch.sum(buf.to(torch.float32))
        f = state.flush_idx
        vals = {
            "t_ms": state.t_ms,
            "accuracy": acc,
            "num_aggregated": count,
            "mean_staleness": torch.sum(staleness * buf) / torch.clamp(count, min=1.0),
            "energy_j": torch.sum(energy),
            "update_latency_ms": torch.max(
                torch.where(buf, state.t_ms - state.pend_t, 0.0)),
            "cold_starts": state.last_cold.to(torch.float32),
            "valid": scalar(1.0, self.device),
        }
        if f < self.max_flushes:  # the JAX package's mode="drop"
            for k, v in state.m_flush.items():
                v[f] = vals[k]
        if self.tap is not None:
            # Decimated on the flush index, decided on the host.
            self.tap.emit({k: v for k, v in vals.items() if k != "valid"}, f)
        queue = state.queue
        if acfg.dispatch_mode == "on_flush":
            queue = self._push_next_dispatch(state, queue, True)
        return state._replace(
            queue=queue,
            params=params,
            sched=sched,
            tel=tel,
            version=state.version + 1,
            flush_idx=f + 1,
            key_uses=uses + 1,
            buf=torch.zeros_like(buf),
            # Cold starts are consumed by the flush that reports them, so
            # repeat flushes between dispatches do not count them again.
            last_cold=torch.zeros_like(state.last_cold),
        )

    # ------------------------------------------------------------------ #
    def _dispatch_core(self, state: AsyncState, ev):
        """The dispatch mechanics without the trailing flush: returns
        ``(state, want_flush)``, ``want_flush`` False or a () bool tensor
        (on_flush mode: an empty cohort flushes at once)."""
        cfg, acfg, sim = self.cfg, self.acfg, self.sim
        n, dev, draws = cfg.num_clients, self.device, sim.draws
        d = state.dispatch_idx

        # --- population mode: lease the N slots to virtual clients ----- #
        # A fresh candidate cohort per dispatch (the cohort.async draw);
        # slots still holding an in-flight or buffered update keep their
        # owner, free slots take the candidate's rows. The owners stay on
        # the device.
        pop_mode = sim._pop_mode
        if pop_mode:
            cand = fog_mod.stratified_cohort(draws, sim.population, n, round=d,
                                             site="cohort.async")
            slot_owner = torch.where(state.busy | state.buf, state.owner, cand)
            tel_view = fog_mod.gather_rows(state.tel, slot_owner)
            prof_view = fog_mod.gather_rows(state.env["profiles"], slot_owner)
            mal_view = torch.index_select(state.env["malicious"], 0, slot_owner)
            cids = slot_owner
        else:
            slot_owner = state.owner
            tel_view, prof_view = state.tel, state.env["profiles"]
            mal_view, cids = state.env["malicious"], None

        # --- churn & availability (between-events process) ------------- #
        online = step_churn(acfg.churn, state.online, state.t_ms - state.last_disp_t,
                            draws, round=d)
        avail = available_mask(acfg.churn, online, tel_view.batt)
        lost = state.busy & ~avail  # stragglers that will never report
        queue = cancel_events(state.queue, lost, KIND_COMPLETE)
        if self._faults_on:
            queue = cancel_events(queue, lost, KIND_RETRY)  # the chain dies too
        busy = state.busy & ~lost

        # --- scheduler gating + policy participation (shared code) ----- #
        data_cfg = self._data_cfg(state)
        hist = sim._histograms(data_cfg, d, cids)
        if pop_mode:
            if cfg.drift_period:
                prev_fn = lambda c, r: sim._histograms(data_cfg, r, c)  # noqa: E731
            else:
                prev_fn = lambda c, r: hist  # noqa: E731
            sched_view = fog_mod.gather_cohort_sched(state.sched, slot_owner, prev_fn)
        else:
            sched_view = state.sched
        decision = schedule_round(sched_view, tel_view, hist, cfg.scheduler,
                                  sim._sched_weights)
        mask = sim._participation(decision, tel_view, d)
        admitted = mask & avail & ~busy & ~state.buf
        deltas, admitted = sim._local_deltas(data_cfg, state.params, d, admitted,
                                             mal_view, cids)

        # --- per-client arrival times (shared cost model + tail) ------- #
        workload, up_bytes, down_bytes = sim._round_workload()
        warm = sched_view.warm
        if cfg.policy in ("fogfaas",):
            warm = torch.zeros_like(warm)
        costs = sim.cost_model.round_costs(
            prof_view, admitted, warm, workload, up_bytes, down_bytes,
            policy="fedfog" if cfg.policy in ("fedfog", "rcs", "vanilla") else "fogfaas",
        )
        per_client_ms = costs.per_client_ms
        if static_on(acfg.straggler_sigma):
            per_client_ms = per_client_ms * torch.exp(
                acfg.straggler_sigma * draws.normal("straggler", (n,), round=d))

        # --- fault plan: attempt-0 outcomes + per-client retry chains -- #
        fkeys = state.pend_fkey
        counts = {}
        if self._faults_on:
            fc = cfg.faults
            part_cut = None
            if static_on(fc.partition_rate):
                part_on = (draws.uniform("async.faults.partition", (), 0.0, 1.0,
                                         round=d) < _f32(fc.partition_rate))
                part_cut = part_on & (
                    draws.uniform("async.faults.partition_frac", (n,), 0.0, 1.0,
                                  round=d) < _f32(fc.partition_frac))
            fail0 = faults_inject.attempt_failures(
                fc, draws, admitted, ~warm, part_cut, 0, round=d, attempts=1,
                prefix="async.faults")
            # Fog outage window of this dispatch: a dark fog loses its edge
            # clients' uplinks; with failover the survivors absorb them at
            # a latency detour, without it the attempt fails.
            if cfg.fog_nodes > 1 and static_on(fc.fog_outage_rate):
                outage = (draws.uniform("async.faults.fog", (cfg.fog_nodes,), 0.0, 1.0,
                                        round=d) < _f32(fc.fog_outage_rate))
                dark = torch.index_select(
                    outage, 0, fog_mod.fog_assignment(n, cfg.fog_nodes, dev))
                if bool(fc.fog_failover):
                    per_client_ms = per_client_ms + torch.where(
                        dark & admitted, _f32(fc.failover_latency_ms), 0.0)
                else:
                    fail0 = fail0 | (admitted & dark)
                counts["fog_outages"] = state.fog_outages + torch.sum(outage).to(torch.int32)
            corrupt0 = faults_inject._fires(draws, "async.faults.corrupt",
                                            fc.corrupt_rate, n, round=d)
            corrupt0 = (torch.zeros_like(admitted) if corrupt0 is None
                        else admitted & ~fail0 & corrupt0)
            fkeys = torch.where(admitted, d, state.pend_fkey)
            # Failed attempts re-enqueue as RETRY carrying the next attempt
            # index; the cap is enforced when that event pops.
            delay1 = faults_config.backoff_ms(fc, 1) if int(fc.max_retries) >= 1 else 0.0
            ev_kinds = torch.where(fail0, KIND_RETRY, KIND_COMPLETE)
            ev_times = state.t_ms + per_client_ms + torch.where(fail0, delay1, 0.0)
            ev_payloads = torch.where(fail0, 1.0, state.t_ms.expand(n))
            counts["fault_failures"] = state.fault_failures + torch.sum(fail0).to(torch.int32)
            counts["fault_corrupt"] = (state.fault_corrupt
                                       + torch.sum(corrupt0).to(torch.int32))
        else:
            ev_kinds = torch.full((n,), KIND_COMPLETE, dtype=torch.int32, device=dev)
            ev_times = state.t_ms + per_client_ms
            ev_payloads = state.t_ms.expand(n)
        queue = push_events(queue, ev_times, torch.arange(n, device=dev), ev_kinds,
                            ev_payloads, admitted)
        if self._faults_on and cfg.faults.deadline_ms is not None:
            # One deadline per dispatch: on_flush mode tags it with the
            # dispatch index (stale once a newer cohort started), interval
            # mode with the dispatch time.
            tag = float(d) if acfg.dispatch_mode == "on_flush" else state.t_ms
            queue = push_event(queue, state.t_ms + _f32(cfg.faults.deadline_ms), -1,
                               KIND_DEADLINE, tag, enable=torch.any(admitted))

        # --- stash in-flight work (fused (N, P) buffer, one `where`) --- #
        deltas_cat, _ = fuse_clients(deltas)
        pending = torch.where(admitted[:, None], deltas_cat, state.pending)
        if self._faults_on and static_on(cfg.faults.corrupt_rate):
            # Attempt-0 corruption lands in the stash now; a corrupted
            # RETRY arrival adds its noise in _retry_core.
            noise0 = (draws.normal("async.faults.noise", tuple(pending.shape), round=d)
                      * _f32(cfg.faults.corrupt_scale))
            pending = pending + torch.where(corrupt0[:, None], noise0, 0.0)
        if pop_mode:
            # Scatter the advanced cohort rows back: warm / LRU from the
            # cold-start cache update, the histogram round; theta_e and
            # energy_spent advance at flush time.
            new_sched = dataclasses.replace(
                state.sched,
                warm=state.sched.warm.index_copy(0, slot_owner, decision.new_state.warm),
                last_used=state.sched.last_used.index_copy(
                    0, slot_owner, decision.new_state.last_used),
                last_hist_round=state.sched.last_hist_round.index_fill(0, slot_owner, d),
                round_index=decision.new_state.round_index,
            )
            new_owner = torch.where(admitted, slot_owner, state.owner)
            new_pend_sizes = torch.where(
                admitted,
                torch.index_select(state.env["data_sizes"], 0, slot_owner).to(torch.float32),
                state.pend_sizes)
        else:
            new_sched, new_owner, new_pend_sizes = (
                decision.new_state, state.owner, state.pend_sizes)
        n_admitted = torch.sum(admitted.to(torch.float32))
        state = state._replace(
            queue=queue,
            sched=new_sched,
            owner=new_owner,
            pend_sizes=new_pend_sizes,
            online=online,
            busy=busy | admitted,
            pending=pending,
            pend_version=torch.where(admitted, state.version, state.pend_version),
            pend_energy=torch.where(admitted, costs.energy_j, state.pend_energy),
            pend_t=torch.where(admitted, state.t_ms, state.pend_t),
            pend_ms=torch.where(admitted, per_client_ms, state.pend_ms),
            pend_fkey=fkeys,
            pend_attempts=torch.where(admitted, 1.0, state.pend_attempts),
            last_admitted=n_admitted,
            lost_inflight=state.lost_inflight + torch.sum(lost.to(torch.int32)),
            last_disp_t=state.t_ms,
            last_cold=state.last_cold + costs.cold_starts,
            dispatch_idx=d + 1,
            key_round=d,
            key_uses=0,
            **counts,
        )
        vals = {
            "t_ms": state.t_ms,
            "num_admitted": n_admitted,
            "num_available": torch.sum(avail.to(torch.float32)),
            "cold_starts": costs.cold_starts.to(torch.float32),
        }
        if d < self.max_dispatches:
            for k, v in state.m_dispatch.items():
                v[d] = vals[k]

        if acfg.dispatch_mode == "interval":
            t_next = state.t_ms + acfg.dispatch_interval_ms
            more = self._more_dispatches(state, t_next)
            if more is not False:
                state = state._replace(queue=push_event(
                    state.queue, t_next, -1, KIND_DISPATCH, enable=more))
            return state, False
        # Empty cohort: nothing will complete, so the round's server step
        # (what the sync round does with an empty mask) runs now and
        # schedules the next dispatch.
        return state, n_admitted == 0

    def _flush_rule(self, busy: Array, buf: Array):
        """Whether the server flushes after absorbing completions: the one
        definition of the count trigger (``buffer_k``) and the idle trigger
        (``flush_on_idle``), shared by both loops. False, or a () bool
        tensor."""
        acfg = self.acfg
        count = torch.sum(buf.to(torch.int32))
        flush_now = False
        if acfg.buffer_k is not None:
            flush_now = count >= acfg.buffer_k
        if acfg.flush_on_idle:
            idle = ~torch.any(busy) & (count > 0)
            flush_now = idle if flush_now is False else flush_now | idle
        return flush_now

    def _complete_core(self, state: AsyncState, pop: _Pop):
        """One COMPLETE (the single-pop loop): the client's update moves
        into the buffer if it is still in flight."""
        c = pop.client
        arrived = state.busy[c]  # stale events were cancelled, but be safe
        is_c = torch.arange(self.cfg.num_clients, device=self.device) == c
        busy = state.busy & ~(is_c & arrived)
        buf = state.buf | (is_c & arrived)
        state = state._replace(busy=busy, buf=buf,
                               completions=state.completions + arrived.to(torch.int32))
        return state, self._flush_rule(busy, buf)

    # ------------------------------------------------------------------ #
    def _retry_core(self, state: AsyncState, ev, pop: _Pop):
        """RETRY: relaunch one client's failed invocation.

        ``pop.attempt`` is the (1-based) attempt index. Past the retry cap
        the failure is terminal: the slot frees and the client never
        reports. Otherwise the attempt's outcome comes from the client's
        retry chain (the ``async.faults.retry`` draw keyed by the dispatch
        that admitted it, the client and the attempt): success pushes the
        COMPLETE at ``t + pend_ms``, failure the next RETRY after
        exponential backoff. A terminal failure takes part in the flush
        decision as an arrival does; a cohort that ended entirely in
        terminal failures still flushes, so the server round advances.
        """
        fc, n, dev = self.cfg.faults, self.cfg.num_clients, self.device
        c, attempt = pop.client, pop.attempt
        cap = int(fc.max_retries)
        active = state.busy[c]  # churn- / deadline-cancelled chains no-op
        is_c = torch.arange(n, device=dev) == c
        i32 = torch.int32
        if attempt > cap:
            busy = state.busy & ~(is_c & active)
            state = state._replace(busy=busy,
                                   fault_terminal=state.fault_terminal + active.to(i32))
            all_terminal = ~torch.any(busy) & (torch.sum(state.buf.to(i32)) == 0)
            rule = self._flush_rule(busy, state.buf)
            return state, active & (all_terminal if rule is False else rule | all_terminal)
        relaunch = active
        u = self.sim.draws.uniform("async.faults.retry", (3,), 0.0, 1.0,
                                   round=pop.fkey, index=c, attempt=attempt)
        draw_fail = (u[0] < _f32(fc.crash_rate)) | (u[1] < _f32(fc.drop_rate))
        fail = relaunch & draw_fail
        succeed = relaunch & ~draw_fail
        corrupt = succeed & (u[2] < _f32(fc.corrupt_rate))
        t_arrive = ev.time + state.pend_ms[c]
        nxt = attempt + 1
        delay = faults_config.backoff_ms(fc, nxt) if nxt <= cap else 0.0
        queue = push_event(
            state.queue,
            torch.where(fail, t_arrive + delay, t_arrive),
            c,
            torch.where(fail, KIND_RETRY, KIND_COMPLETE),
            torch.where(fail, float(nxt), state.pend_t[c]),
            enable=relaunch,
        )
        pending = state.pending
        if static_on(fc.corrupt_rate):
            noise = (self.sim.draws.normal("async.faults.retry_noise",
                                           (pending.shape[1],), round=pop.fkey,
                                           index=c, attempt=attempt)
                     * _f32(fc.corrupt_scale))
            pending = pending.clone()
            pending[c] += torch.where(corrupt, noise, 0.0)
        state = state._replace(
            queue=queue,
            pending=pending,
            pend_attempts=state.pend_attempts + torch.where(is_c & relaunch, 1.0, 0.0),
            fault_retries=state.fault_retries + relaunch.to(i32),
            fault_failures=state.fault_failures + fail.to(i32),
            fault_corrupt=state.fault_corrupt + corrupt.to(i32),
        )
        return state, False  # only a terminal failure can flush

    # ------------------------------------------------------------------ #
    def _deadline_core(self, state: AsyncState, ev, pop: _Pop):
        """DEADLINE: shed overdue in-flight work, then decide.

        on_flush mode: the event is stale once a newer cohort started or
        the cohort already resolved. A live deadline cancels the cohort's
        remaining COMPLETE / RETRY events, counts them lost, and applies
        the quorum rule: enough arrivals flush the partial buffer; below
        quorum the round is skipped (buffer cleared, model untouched) and
        the next dispatch is scheduled as a flush would have. The skip is
        a masked update, not a host decision.

        interval mode: sheds only work dispatched at or before the tag
        time, then the shared flush rule decides.
        """
        fc = self.cfg.faults
        on_flush = self.acfg.dispatch_mode == "on_flush"
        if on_flush:
            live = ((state.dispatch_idx == ev.payload.to(torch.int32) + 1)
                    & (torch.any(state.busy) | torch.any(state.buf)))
            overdue = state.busy & live
        else:
            overdue = state.busy & (state.pend_t <= ev.payload)
        queue = cancel_events(state.queue, overdue, KIND_COMPLETE)
        queue = cancel_events(queue, overdue, KIND_RETRY)
        state = state._replace(
            queue=queue,
            busy=state.busy & ~overdue,
            fault_lost_deadline=state.fault_lost_deadline
            + torch.sum(overdue.to(torch.int32)),
        )
        if not on_flush:
            return state, self._flush_rule(state.busy, state.buf)
        count = torch.sum(state.buf.to(torch.float32))
        meets = (count > 0) & (count >= _f32(fc.quorum_frac) * state.last_admitted)
        skip = live & ~meets
        state = state._replace(
            queue=self._push_next_dispatch(state, state.queue, skip),
            buf=state.buf & ~skip,
            last_cold=torch.where(skip, 0, state.last_cold),
            fault_skipped=state.fault_skipped + skip.to(torch.int32),
        )
        return state, live & meets

    # ------------------------------------------------------------------ #
    def _host_pop(self, state, valid, kind, client, payload) -> _Pop | None:
        """One copy to the host of an event's validity, kind and client,
        and (with faults) the attempt and retry chain a RETRY keys its
        draws by. None when the queue was empty."""
        c = torch.clamp(client.to(torch.int64), 0, self.cfg.num_clients - 1)
        parts = [valid.to(torch.int64), kind.to(torch.int64), c]
        if self._faults_on:
            parts += [torch.clamp(payload.to(torch.int64), min=1),
                      torch.index_select(state.pend_fkey, 0, c.reshape(1))[0].to(
                          torch.int64)]
        host = torch.stack(parts).tolist()
        if not host[0]:
            return None
        return _Pop(host[1], host[2], *(host[3:] if self._faults_on else (1, 0)))

    def _take_flush(self, state, want_flush):
        """The host's flush decision (a copy when ``want_flush`` is a
        tensor), and the flush."""
        if want_flush is not False and bool(want_flush):
            return self._flush(state)
        return state

    def _coalesced_step(self, state: AsyncState):
        """One batched step, equal to a run of single pops: a non-COMPLETE
        event pops alone; otherwise the run of COMPLETE events before the
        first barrier in pop order, capped at the ``buffer_k`` boundary,
        fills the buffer in one masked update and the flush rule is
        applied once at its end. Returns None once the queue is empty."""
        acfg, n = self.acfg, self.cfg.num_clients
        q = state.queue
        rank = pop_order_rank(q)
        first = torch.argmin(rank).reshape(1)
        take = lambda a: torch.index_select(a, 0, first)[0]  # noqa: E731
        pop = self._host_pop(state, torch.any(q.valid), take(q.kind), take(q.client),
                             take(q.payload))
        if pop is None:
            return None
        if pop.kind == KIND_COMPLETE or (not self._faults_on
                                         and pop.kind != KIND_DISPATCH):
            # COMPLETEs before the first barrier: without faults the only
            # barrier is a DISPATCH; with faults RETRY and DEADLINE are too.
            if self._faults_on:
                barrier = q.valid & (q.kind != KIND_COMPLETE)
            else:
                barrier = q.valid & (q.kind == KIND_DISPATCH)
            n_take = torch.min(torch.where(barrier, rank, q.capacity))
            if acfg.buffer_k is not None:
                # The single-pop loop flushes as soon as the buffer holds K,
                # so a batch absorbs only the room left (>= 1).
                room = torch.clamp(acfg.buffer_k - torch.sum(state.buf.to(torch.int32)),
                                   min=1)
                n_take = torch.minimum(n_take, room)
            popped, t_last, q2 = pop_batch(q, n_take, rank)
            cids = torch.clamp(q.client.to(torch.int64), 0, n - 1)
            arrived = torch.zeros((n,), dtype=torch.int32, device=self.device).index_add_(
                0, cids, popped.to(torch.int32)) > 0
            arrived = arrived & state.busy  # the single pop's guard
            state = state._replace(
                queue=q2,
                t_ms=torch.maximum(state.t_ms, t_last),
                busy=state.busy & ~arrived,
                buf=state.buf | arrived,
                completions=state.completions + torch.sum(arrived.to(torch.int32)),
            )
            want = self._flush_rule(state.busy, state.buf)
        else:
            ev, q2 = pop_event(q)
            state = state._replace(queue=q2, t_ms=torch.maximum(ev.time, state.t_ms))
            if pop.kind == KIND_DISPATCH:
                state, want = self._dispatch_core(state, ev)
            elif pop.kind == KIND_RETRY:
                state, want = self._retry_core(state, ev, pop)
            else:
                state, want = self._deadline_core(state, ev, pop)
        return self._take_flush(state, want)

    def _single_step(self, state: AsyncState):
        """One pop, one handler: the oracle of the coalesced loop. Returns
        None once the queue is empty."""
        ev, q = pop_event(state.queue)
        pop = self._host_pop(state, ev.valid, ev.kind, ev.client, ev.payload)
        if pop is None:
            return None
        state = state._replace(queue=q, t_ms=torch.maximum(ev.time, state.t_ms))
        if pop.kind == KIND_DISPATCH:
            state, want = self._dispatch_core(state, ev)
        elif pop.kind == KIND_RETRY and self._faults_on:
            state, want = self._retry_core(state, ev, pop)
        elif pop.kind == KIND_DEADLINE and self._faults_on:
            state, want = self._deadline_core(state, ev, pop)
        else:
            state, want = self._complete_core(state, pop)
        return self._take_flush(state, want)

    def _scan_events(self, state: AsyncState) -> AsyncState:
        """The whole experiment: coalesced steps (default) or single pops
        until the queue drains, ``max_events`` steps at most."""
        step = self._coalesced_step if self.acfg.coalesce else self._single_step
        self.steps = 0
        while self.steps < self.max_events:
            nxt = step(state)
            if nxt is None:
                break
            state = nxt
            self.steps += 1
        return state

    def metrics_for_seed(self, seed: int) -> dict[str, Array]:
        """Seed -> the flush metric tensors, padded to ``max_flushes`` with
        a ``valid`` channel, plus every engine-health and fault counter as
        a scalar channel (the sweep's per-seed hook); nothing is copied to
        the host."""
        final = self._scan_events(self.init_state(seed))
        return {
            **final.m_flush,
            "queue_dropped": final.queue.dropped,
            "lost_inflight": final.lost_inflight,
            "completions": final.completions,
            "dispatched_total": torch.sum(final.m_dispatch["num_admitted"]),
            **self._fault_counters(final),
        }

    @staticmethod
    def _fault_counters(state: AsyncState) -> dict[str, Array]:
        """The fault-layer counter channels (zeros when faults are off)."""
        return {k: getattr(state, k) for k in _FAULT_COUNTERS}

    # ------------------------------------------------------------------ #
    def run(self, seed: int | None = None) -> dict[str, Any]:
        """Run one async experiment; returns a history dict: per-flush
        metric lists (trimmed to the flush count), per-dispatch lists
        (``dispatch_*``) and summary scalars. The metrics move to the host
        in one copy at the end."""
        state = self.init_state(self.cfg.seed if seed is None else seed)
        return self.history(self._scan_events(state))

    def history(self, final: AsyncState) -> dict[str, Any]:
        """``run()``'s history of a final state: one copy to the host;
        raises on a queue overflow, warns on churn losses."""
        n_f, n_d = final.flush_idx, final.dispatch_idx
        scalars = {"t_ms": final.t_ms, "completions": final.completions,
                   "lost_inflight": final.lost_inflight,
                   "queue_dropped": final.queue.dropped, **self._fault_counters(final)}
        flat = torch.cat(
            [v.to(torch.float64) for v in final.m_flush.values()]
            + [v.to(torch.float64) for v in final.m_dispatch.values()]
            + [torch.stack([v.to(torch.float64) for v in scalars.values()])]
        ).cpu().numpy()  # the single device -> host transfer
        nf, nd = self.max_flushes, self.max_dispatches
        m_flush = {k: flat[i * nf:(i + 1) * nf] for i, k in enumerate(final.m_flush)}
        off = len(m_flush) * nf
        m_disp = {k: flat[off + i * nd:off + (i + 1) * nd]
                  for i, k in enumerate(final.m_dispatch)}
        host = dict(zip(scalars, flat[off + len(m_disp) * nd:].tolist()))
        dropped = int(host["queue_dropped"])
        if dropped:
            # Overflow corrupts the flush history: fatal, but surfaced
            # through the tracker first.
            msg = (f"event queue overflowed ({dropped} dropped); raise "
                   f"AsyncConfig.queue_capacity above {self.capacity}")
            self._warn("queue_overflow", msg, queue_dropped=dropped)
            raise RuntimeError(msg)
        history = assemble_async_history(m_flush, m_disp, n_f, n_d)
        n_lost = int(host["lost_inflight"])
        history["num_dispatches"] = n_d
        history["num_flushes"] = n_f
        history["num_completions"] = int(host["completions"])
        history["lost_inflight"] = n_lost
        history["virtual_time_ms"] = host["t_ms"]
        for k in _FAULT_COUNTERS:
            history[k] = int(host[k])
        if n_lost > 0:
            self._warn(
                "lost_inflight",
                f"{n_lost} in-flight update(s) never reported (client churned "
                f"out mid-flight) across {n_d} dispatches — check churn rates "
                f"vs straggler tail",
                lost_inflight=n_lost, num_dispatches=n_d,
            )
        finalize_history(history)
        if self.tap is not None:
            self.tap.tracker.log_summary({**self.tap.const, **summary_metrics(history)})
        return history

    def _warn(self, kind: str, message: str, **data) -> None:
        """Engine-health warning: a tracker event when a tap is attached,
        else ``warnings.warn``."""
        if self.tap is not None:
            self.tap.tracker.log({"event": "warning", "kind": kind, "message": message,
                                  **self.tap.const, **data})
        else:
            warnings.warn(f"[async engine] {message}", RuntimeWarning, stacklevel=3)


def _smoke(argv=None) -> dict[str, Any]:
    """CLI smoke: a short virtual-horizon FedBuff run of 16 clients, on the
    CUDA card unless ``--device`` names another.

        python -m repro_torch.sim.events.engine [--horizon-ms 2000] [--device cpu]
    """
    import argparse

    ap = argparse.ArgumentParser(description=_smoke.__doc__)
    ap.add_argument("--horizon-ms", type=float, default=2000.0)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--buffer-k", type=int, default=4)
    ap.add_argument("--interval-ms", type=float, default=250.0)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    sim = AsyncFedFogSimulator(
        SimulatorConfig(task="emnist", num_clients=args.clients, rounds=64, top_k=8,
                        hidden=(32,), seed=0),
        AsyncConfig.fedbuff(
            args.buffer_k,
            dispatch_interval_ms=args.interval_ms,
            horizon_ms=args.horizon_ms,
            straggler_sigma=0.3,
            churn=ChurnConfig(arrival_rate=0.05, departure_rate=0.05),
        ),
        device=args.device,
    )
    h = sim.run()
    print(
        f"async smoke: horizon={args.horizon_ms:.0f}ms "
        f"dispatches={h['num_dispatches']} flushes={h['num_flushes']} "
        f"completions={h['num_completions']} lost={h['lost_inflight']} "
        f"final_acc={h['final_accuracy']:.3f} "
        f"virtual_t={h['virtual_time_ms']:.0f}ms"
    )
    assert h["num_flushes"] > 0 and h["num_dispatches"] > 0
    return h


if __name__ == "__main__":
    _smoke()
