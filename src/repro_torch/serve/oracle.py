"""Sequential per-request serving oracle (port of ``repro/serve/oracle.py``).

The slow reference for the continuous-batching engine: serve the trace
one request at a time (prefill, then batch-1 greedy decode to the
request's length) with the same §IV.F cost accounting. Its contiguous
``cache_len`` is ``PagePlan.cache_len`` (page-table width x page size),
so the engine's dense path reduces over identically shaped operands and
must reproduce its tokens exactly. Tokens stay on the device in the same
``(R + 1, max_gen)`` buffer, read once at the end.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.models.transformer import Runtime, greedy
from repro_torch.serve.arrivals import RequestTrace
from repro_torch.serve.costs import ServeCostModel
from repro_torch.serve.engine import EngineConfig, ServeReport, summarize, trace_embeds
from repro_torch.serve.paged import PagePlan, check_family


class SequentialOracle:
    """One-request-at-a-time reference server (batch 1, no slots)."""

    def __init__(self, model: Model, params, cfg: EngineConfig = EngineConfig(),
                 cost: ServeCostModel = ServeCostModel(), runtime: Runtime = Runtime()):
        check_family(model.cfg)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.cost = cost
        self.runtime = runtime
        self.device = params["embed"].device
        self.plan = PagePlan.build(model.cfg, cfg.prompt_len, cfg.max_gen,
                                   page_size=cfg.page_size, n_patches=cfg.n_patches)

    @torch.no_grad()
    def serve(self, trace: RequestTrace) -> ServeReport:
        cfg, plan, cost, model = self.cfg, self.plan, self.cost, self.model
        r = trace.n_requests
        if r > cfg.max_requests:
            raise ValueError(f"trace of {r} > max_requests={cfg.max_requests}")
        dev = self.device
        out_buf = torch.zeros((cfg.max_requests + 1, cfg.max_gen), dtype=torch.int32,
                              device=dev)
        prompts = torch.from_numpy(np.ascontiguousarray(trace.prompts)).to(dev)
        embeds = trace_embeds(trace, plan, dev)
        vclock = 0.0
        last_busy = -math.inf
        latency = np.full((r,), np.nan)
        fpt = model.flops_per_token(train=False)
        prompt_flops = fpt * plan.prompt_eff
        energy = 0.0
        cold_starts = decode_steps = tokens_generated = 0
        slo_violations = 0

        wall0 = time.perf_counter()
        for req in range(r):  # trace arrival times are nondecreasing
            arrival = float(trace.arrival_ms[req])
            start = max(vclock, arrival)
            warm = (start - last_busy) <= cost.keep_alive_ms
            batch = {"tokens": prompts[req:req + 1]}
            if embeds is not None:
                batch["patch_embeds"] = embeds[req:req + 1]
            logits, cache = model.prefill(self.params, batch, cache_len=plan.cache_len,
                                          runtime=self.runtime)
            tok = greedy(logits[:, -1], self.runtime)[:, None]  # (1, 1)
            out_buf[req, 0] = tok[0, 0].to(out_buf.dtype)
            vclock = start + cost.prefill_ms(prompt_flops, warm)
            energy += cost.prefill_energy_j(prompt_flops, warm)
            cold_starts += not warm
            tokens_generated += 1
            for i in range(1, int(trace.gen_len[req])):
                logits, cache = model.decode_step(self.params, cache, tok, self.runtime)
                tok = greedy(logits[:, -1], self.runtime)[:, None]
                out_buf[req, i] = tok[0, 0].to(out_buf.dtype)
                decode_steps += 1
                tokens_generated += 1
                vclock += cost.decode_step_ms(fpt)
                energy += cost.step_energy_j(fpt, 1)
            latency[req] = vclock - arrival
            slo_violations += latency[req] > trace.slo_ms
            last_busy = vclock

        tokens_np = out_buf[:r].cpu().numpy()
        wall = time.perf_counter() - wall0
        return ServeReport(
            n_requests=r,
            completed=r,
            rejected=0,
            slo_violations=slo_violations,
            tokens_generated=tokens_generated,
            decode_steps=decode_steps,
            prefills=r,
            cold_starts=cold_starts,
            virtual_ms=vclock,
            wall_s=wall,
            latency_ms=latency,
            counters=dict(arrived=r, completed=r, rejected=0, in_flight=0, waiting=0),
            tokens=tokens_np,
            gen_len=trace.gen_len.copy(),
            **summarize(trace, latency, vclock, wall, tokens_generated, energy),
        )
