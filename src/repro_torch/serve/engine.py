"""Continuous-batching serving engine (port of ``repro/serve/engine.py``:
``EngineConfig``, ``ServeReport``, ``ContinuousBatchingEngine``).

Fixed-capacity SLOTS hold in-flight requests; the device state (page
pool, per-slot next token, output buffer) is fixed-shape. A prefill ->
insert -> generate loop evicts finished slots and refills them mid-flight
from the waiting queue. Arrivals come from a ``sim.events`` queue popped
against the engine's virtual clock; the clock and the §IV.F accounting
ride ``serve.costs.ServeCostModel``. Generated tokens land in a
device-resident ``(max_requests + 1, max_gen)`` buffer, read by the host
once, after the whole trace.

Host and device state. The slot control rows (positions, activity, page
table, output routing) live twice: as numpy mirrors that the host
scheduler reads and writes, and as device tensors that the decode step
reads. The host never writes a tensor it has handed to the device: after
an admission or an eviction it uploads the mirrors as NEW tensors (a
blocking copy), and between those the decode loop advances the device
copies with out-of-place device ops. (The JAX engine hands its decode
executable host arrays and then mutates them while the asynchronous
dispatch may still read them; ROADMAP.md R2.)

Correctness contract: with ``attn="dense"`` the engine reproduces the
sequential per-request oracle token for token; ``attn="paged"`` swaps in
K7 (float tolerance on the logits). Eager PyTorch compiles nothing, so
the JAX report's ``n_compiles`` has no counterpart here.

Under mesh rules (``runtime.tensor``, a DENSE model on one rank's
blocks) every rank runs this loop: its host schedule, page table and
control tensors come from the trace alone, and the token pick is
gathered before any rank reads it, so every rank makes the same
decisions; its pool holds its kv heads. :meth:`decode_collectives` is
the census of one decode step (the JAX engine's ``decode_hlo_text`` read
by ``analyze_hlo``).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.models.transformer import Runtime
from repro_torch.serve.arrivals import RequestTrace
from repro_torch.serve.costs import ServeCostModel
from repro_torch.serve.paged import PagePlan, init_pool, make_admit_fn, make_decode_fn
from repro_torch.serve.scheduler import PageAllocator, SlotScheduler
from repro_torch.sim.events.queue import peek_time, pop_event


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    slots: int = 8
    page_size: int = 16
    prompt_len: int = 16
    max_gen: int = 16  # per-request generation cap (sizes slot span)
    max_requests: int = 256  # output-buffer rows; traces must fit
    num_pages: int = 0  # physical pool size; 0 = slots * pages_per_slot
    attn: str = "dense"  # "dense" (oracle-exact) | "paged" (K7)
    policy: str = "fifo"  # waiting-queue order: "fifo" | "edf"
    max_queue: int = 0  # admission cap (0 = unbounded); over -> rejected
    n_patches: int = 8  # VLM frontend tokens per request


@dataclasses.dataclass
class ServeReport:
    """Everything one trace produced (host-side; device read once)."""

    n_requests: int
    completed: int
    rejected: int
    slo_violations: int
    tokens_generated: int
    decode_steps: int
    prefills: int
    cold_starts: int
    virtual_ms: float
    wall_s: float
    latency_ms: np.ndarray  # (R,) NaN for rejected
    percentiles: dict[str, float]  # p50/p95/p99 over completed requests
    goodput_rps: float  # SLO-met completions per virtual second
    tokens_per_s: float  # virtual-time throughput
    tokens_per_wall_s: float  # wall-clock throughput
    energy_j: float
    energy_per_token_j: float
    counters: dict[str, int]
    tokens: np.ndarray  # (R, max_gen) int32; row r valid to gen_len[r]
    gen_len: np.ndarray  # (R,)
    # serve(keep_logits=True): the first decode step's logits of the slots
    # it advanced, in slot order (the rank's vocabulary block under rules)
    first_logits: torch.Tensor | None = None

    def tokens_for(self, req: int) -> list[int]:
        return self.tokens[req, : int(self.gen_len[req])].tolist()


def trace_embeds(trace: RequestTrace, plan: PagePlan, device):
    """The trace's VLM patch embeddings (R, n_patches, d) on ``device``,
    copied once before the loop; None when the plan prepends no patches."""
    if not plan.n_patches:
        return None
    if trace.patch_embeds is None or trace.patch_embeds.shape[1] != plan.n_patches:
        raise ValueError(f"a VLM trace needs patch_embeds of {plan.n_patches} patches")
    return torch.from_numpy(np.ascontiguousarray(trace.patch_embeds)).to(device)


def summarize(trace: RequestTrace, latency: np.ndarray, vclock: float, wall: float,
              tokens_generated: int, energy: float) -> dict:
    """The report's latency percentiles and rates, shared with the oracle."""
    lat_done = latency[~np.isnan(latency)]
    pct = {
        f"p{p}": float(np.percentile(lat_done, p)) if lat_done.size else float("nan")
        for p in (50, 95, 99)
    }
    in_slo = int(np.sum(lat_done <= trace.slo_ms)) if lat_done.size else 0
    vsec = max(vclock / 1e3, 1e-9)
    return dict(
        percentiles=pct,
        goodput_rps=in_slo / vsec,
        tokens_per_s=tokens_generated / vsec,
        tokens_per_wall_s=tokens_generated / max(wall, 1e-9),
        energy_j=energy,
        energy_per_token_j=energy / max(tokens_generated, 1),
    )


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a fixed page pool, on the
    device the parameters live on."""

    def __init__(self, model: Model, params, cfg: EngineConfig = EngineConfig(),
                 cost: ServeCostModel = ServeCostModel(), runtime: Runtime = Runtime(),
                 tap=None):
        """``tap`` (a :class:`repro_torch.obs.MetricTap`) receives one
        decimated row per decode step from the host's counters; it adds
        no device transfer."""
        from repro_torch.serve.static import serving_params

        self.model = model
        self.tap = tap
        self.params = serving_params(params, runtime)
        self.cfg = cfg
        self.cost = cost
        self.device = params["embed"].device
        self.plan = PagePlan.build(model.cfg, cfg.prompt_len, cfg.max_gen,
                                   page_size=cfg.page_size, n_patches=cfg.n_patches)
        self.num_pages = cfg.num_pages or cfg.slots * self.plan.pages_per_slot
        if self.plan.pages_per_slot > self.num_pages:
            raise ValueError(
                f"pool of {self.num_pages} pages cannot hold one request "
                f"({self.plan.pages_per_slot} pages)"
            )
        self.runtime = runtime
        self._admit = make_admit_fn(model, self.plan, runtime)
        self._decode = make_decode_fn(model, self.plan, runtime, cfg.attn)

    def decode_collectives(self):
        """The collectives of one decode step (``dist.collectives.
        CollectiveStats``), read off a step over a zeroed pool with every
        slot idle: the same program as every step of :meth:`serve`. Every
        rank of the runtime's groups must call it together."""
        from repro_torch.dist.collectives import CollectiveLog

        cfg, s = self.cfg, self.cfg.slots
        dev = self.device
        pool = init_pool(self.model.cfg, self.plan, s, self.num_pages, device=dev,
                         runtime=self.runtime)
        tokens = torch.zeros((s, 1), dtype=torch.int64, device=dev)
        out_buf = torch.zeros((cfg.max_requests + 1, cfg.max_gen), dtype=torch.int32,
                              device=dev)
        zeros = np.zeros((s,), np.int64)
        ctrl = self._upload(np.zeros((s, self.plan.pages_per_slot), np.int64), zeros,
                            zeros.astype(bool), np.full((s,), cfg.max_requests), zeros)
        with CollectiveLog() as log:
            self._decode(self.params, pool, tokens, out_buf, ctrl["page_table"],
                         ctrl["positions"], ctrl["active"], ctrl["out_req"], ctrl["out_idx"])
        return log.stats()

    def _upload(self, page_table, positions, active, out_req, out_idx):
        """Fresh device copies of the host mirrors (one blocking copy)."""
        s = self.cfg.slots
        ctrl = np.concatenate(
            [positions[:, None], active[:, None], out_req[:, None], out_idx[:, None],
             page_table], axis=1).astype(np.int64)
        dev = torch.from_numpy(ctrl).to(self.device)
        return dict(positions=dev[:, 0], active=dev[:, 1].bool(), out_req=dev[:, 2],
                    out_idx=dev[:, 3], page_table=dev[:, 4:].to(torch.int32).contiguous().reshape(s, -1))

    # ------------------------------------------------------------------ #
    def serve(self, trace: RequestTrace, max_steps: int = 0,
              keep_logits: bool = False) -> ServeReport:
        """Serve ``trace`` (at most ``max_steps`` decode steps when > 0);
        ``keep_logits`` keeps the first decode step's logits of its live
        slots (``ServeReport.first_logits``)."""
        cfg, plan, cost = self.cfg, self.plan, self.cost
        dev = self.device
        r = trace.n_requests
        if r > cfg.max_requests:
            raise ValueError(f"trace of {r} > max_requests={cfg.max_requests}")
        if trace.prompts.shape[1] != plan.prompt_len:
            raise ValueError("trace prompt_len != engine prompt_len")
        if int(trace.gen_len.max()) > plan.max_gen or int(trace.gen_len.min()) < 1:
            raise ValueError("trace gen_len outside [1, max_gen]")
        if plan.pages_for_gen(int(trace.gen_len.max())) > self.num_pages:
            raise ValueError("a request needs more pages than the pool holds")

        sched = SlotScheduler(cfg.slots, cfg.max_queue, cfg.policy)
        alloc = PageAllocator(self.num_pages)
        pool = init_pool(self.model.cfg, plan, cfg.slots, self.num_pages, device=dev,
                         runtime=self.runtime)
        tokens = torch.zeros((cfg.slots, 1), dtype=torch.int64, device=dev)
        out_buf = torch.zeros((cfg.max_requests + 1, cfg.max_gen), dtype=torch.int32,
                              device=dev)
        prompts = torch.from_numpy(np.ascontiguousarray(trace.prompts)).to(dev)
        embeds = trace_embeds(trace, plan, dev)

        n_tab = plan.pages_per_slot
        page_table = np.zeros((cfg.slots, n_tab), np.int64)
        positions = np.zeros((cfg.slots,), np.int64)
        active = np.zeros((cfg.slots,), bool)
        out_req = np.full((cfg.slots,), cfg.max_requests, np.int64)  # trash row
        out_idx = np.zeros((cfg.slots,), np.int64)
        ctrl = None  # device copies; None = the mirrors changed since the upload
        first_logits = None

        queue = trace.queue
        vclock = 0.0
        last_busy = -math.inf  # first admission is always a cold start
        latency = np.full((r,), np.nan)
        fpt = self.model.flops_per_token(train=False)
        prompt_flops = fpt * plan.prompt_eff
        energy = 0.0
        cold_starts = prefills = decode_steps = tokens_generated = 0
        slo_violations = 0

        def finish(slot: int) -> None:
            nonlocal slo_violations, ctrl
            st = sched.on_complete(slot)
            alloc.free(st.pages)
            latency[st.req] = vclock - float(trace.arrival_ms[st.req])
            slo_violations += vclock > st.deadline_ms
            page_table[slot] = 0
            positions[slot] = 0
            active[slot] = False
            out_req[slot] = cfg.max_requests
            out_idx[slot] = 0
            ctrl = None

        wall0 = time.perf_counter()
        while sched.completed + sched.rejected < r:
            # 1. Drain arrivals that are due at the current virtual time.
            while True:
                t = float(peek_time(queue))
                if not t <= vclock:
                    break
                ev, queue = pop_event(queue)
                sched.on_arrival(int(ev.payload), t + trace.slo_ms)
            # 2. Refill free slots from the waiting queue (policy order).
            while True:
                nxt = sched.next_fill()
                if nxt is None:
                    break
                req, deadline = nxt
                gen = int(trace.gen_len[req])
                pages = alloc.alloc(plan.pages_for_gen(gen))
                if pages is None:
                    break  # pool exhausted; retry after evictions
                warm = (vclock - last_busy) <= cost.keep_alive_ms
                slot = sched.on_insert(req, pages, gen - 1, deadline)
                row = np.zeros((n_tab,), np.int64)
                row[: len(pages)] = pages
                prompt_pages = torch.from_numpy(row[: plan.prompt_pages]).to(dev)
                admit_args = [prompts[req:req + 1]]
                if embeds is not None:
                    admit_args.append(embeds[req:req + 1])
                pool, tokens, out_buf = self._admit(
                    self.params, pool, tokens, out_buf, *admit_args, prompt_pages, slot, req,
                )
                vclock += cost.prefill_ms(prompt_flops, warm)
                energy += cost.prefill_energy_j(prompt_flops, warm)
                cold_starts += not warm
                prefills += 1
                tokens_generated += 1  # prefill emits the first token
                last_busy = vclock
                if sched.slots[slot].remaining == 0:
                    finish(slot)  # gen_len == 1: done at prefill
                    continue
                page_table[slot] = row
                positions[slot] = plan.prompt_eff
                active[slot] = True
                out_req[slot] = req
                out_idx[slot] = 1
                ctrl = None
            # 3. Idle: jump the clock to the next arrival.
            if not active.any():
                t = float(peek_time(queue))
                if math.isinf(t):
                    assert not sched.waiting, "stuck with waiting requests"
                    continue  # loop condition decides termination
                vclock = max(vclock, t)
                continue
            # 4. One batched decode step.
            if ctrl is None:
                ctrl = self._upload(page_table, positions, active, out_req, out_idx)
            args = (self.params, pool, tokens, out_buf, ctrl["page_table"],
                    ctrl["positions"], ctrl["active"], ctrl["out_req"], ctrl["out_idx"])
            if keep_logits and first_logits is None:
                pool, tokens, out_buf, logits = self._decode(*args, keep_logits=True)
                live = torch.from_numpy(np.nonzero(active)[0]).to(dev)
                first_logits = logits[live]
            else:
                pool, tokens, out_buf = self._decode(*args)
            n_active = int(active.sum())
            decode_steps += 1
            tokens_generated += n_active
            vclock += cost.decode_step_ms(fpt * n_active)
            energy += cost.step_energy_j(fpt * n_active, n_active)
            last_busy = vclock
            if self.tap is not None:
                self.tap.host_log(
                    {
                        "virtual_ms": vclock,
                        "active_slots": n_active,
                        "waiting": len(sched.waiting),
                        "completed": sched.completed,
                        "tokens_generated": tokens_generated,
                        "energy_j": energy,
                    },
                    step=decode_steps,
                )
            # 5. Advance live slots (device copies out of place); evict the
            # finished ones.
            step = ctrl["active"].long()
            ctrl = dict(ctrl, positions=ctrl["positions"] + step,
                        out_idx=ctrl["out_idx"] + step)
            for slot in np.nonzero(active)[0]:
                positions[slot] += 1
                out_idx[slot] += 1
                st = sched.slots[slot]
                st.remaining -= 1
                if st.remaining == 0:
                    finish(int(slot))
            if max_steps and decode_steps >= max_steps:
                break

        # ONE terminal device -> host read of every request's tokens.
        tokens_np = out_buf[:r].cpu().numpy()
        wall = time.perf_counter() - wall0
        return ServeReport(
            n_requests=r,
            completed=sched.completed,
            rejected=sched.rejected,
            slo_violations=slo_violations,
            tokens_generated=tokens_generated,
            decode_steps=decode_steps,
            prefills=prefills,
            cold_starts=cold_starts,
            virtual_ms=vclock,
            wall_s=wall,
            latency_ms=latency,
            counters=sched.conservation(),
            tokens=tokens_np,
            gen_len=trace.gen_len.copy(),
            first_logits=first_logits,
            **summarize(trace, latency, vclock, wall, tokens_generated, energy),
        )
