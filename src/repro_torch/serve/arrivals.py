"""Request arrival process for the serving engine, on the event queue
(port of ``repro/serve/arrivals.py``).

Arrivals are a (possibly diurnally modulated) Poisson process: the gap
after time ``t`` is Exp(rate(t)) with

    rate(t) = rate_per_s * (1 + diurnal_amp * sin(2π t / period)).

Each request gets a prompt, a generation length and an SLO deadline, and
is pushed into a ``sim.events`` queue as a ``KIND_ARRIVE`` event whose
payload is the request id. The draws go through a draw provider
(``repro_torch.random``) under the sites ``serve.arrival`` (uniforms of
the inter-arrival gaps), ``serve.gen_len``, ``serve.prompts`` and, for a
VLM model, ``serve.patches`` (its patch embeddings, rounded to the
model's compute dtype); the
JAX package draws them from a key, so the two traces differ for one
seed. :func:`trace_from_arrays` builds a trace from given arrays, which
is how a test serves the JAX package's own trace.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.sim.events.queue import KIND_ARRIVE, EventQueue, make_queue, push_events


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_requests: int = 32
    rate_per_s: float = 20.0  # mean arrival rate (virtual seconds)
    diurnal_amp: float = 0.0  # 0..1 sinusoidal rate modulation
    diurnal_period_ms: float = 60_000.0
    slo_ms: float = 4_000.0  # per-request completion deadline
    prompt_len: int = 16
    min_gen: int = 4
    max_gen: int = 16  # inclusive; also sizes the slot span


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    """One materialised arrival trace, all on the host."""

    arrival_ms: np.ndarray  # (R,) f64, nondecreasing
    gen_len: np.ndarray  # (R,) i64 in [min_gen, max_gen]
    slo_ms: float
    prompts: np.ndarray  # (R, prompt_len) i32
    patch_embeds: np.ndarray | None  # (R, n_patches, d) f32 for VLM archs
    queue: EventQueue  # KIND_ARRIVE events on the CPU, payload = request id

    @property
    def n_requests(self) -> int:
        return int(self.arrival_ms.shape[0])

    def deadline_ms(self, req: int) -> float:
        return float(self.arrival_ms[req]) + self.slo_ms


def _arrival_times(u: np.ndarray, cfg: TraceConfig) -> np.ndarray:
    """Inverse-CDF Poisson thinning with a time-varying rate."""
    t = 0.0
    out = np.empty(len(u), np.float64)
    for i, ui in enumerate(u):
        rate = cfg.rate_per_s * (
            1.0 + cfg.diurnal_amp * math.sin(2.0 * math.pi * t / cfg.diurnal_period_ms * 1e3)
        )
        rate = max(rate, 1e-6)
        t += -math.log(max(1.0 - ui, 1e-12)) / rate * 1e3  # gap in ms
        out[i] = t
    return out


def trace_from_arrays(arrival_ms, gen_len, prompts, slo_ms: float,
                      patch_embeds=None) -> RequestTrace:
    """A trace from host arrays: arrival times (R,), generation lengths
    (R,), prompts (R, prompt_len) and, for a VLM model, patch embeddings
    (R, n_patches, d) (held as float32); its queue holds one KIND_ARRIVE
    event per request."""
    arrival = np.asarray(arrival_ms, np.float64)
    r = arrival.shape[0]
    q = push_events(
        make_queue(r),
        times=torch.as_tensor(arrival, dtype=torch.float32),
        clients=torch.arange(r, dtype=torch.int32),
        kinds=torch.full((r,), KIND_ARRIVE, dtype=torch.int32),
        payloads=torch.arange(r, dtype=torch.float32),
        mask=torch.ones((r,), dtype=torch.bool),
    )
    return RequestTrace(
        arrival_ms=arrival,
        gen_len=np.asarray(gen_len, np.int64),
        slo_ms=float(slo_ms),
        prompts=np.array(prompts, np.int32),  # a writable copy
        patch_embeds=None if patch_embeds is None else np.array(patch_embeds, np.float32),
        queue=q,
    )


def make_trace(draws, cfg: TraceConfig, model_cfg=None, n_patches: int = 8) -> RequestTrace:
    """Sample a reproducible request trace for ``model_cfg`` (or a generic
    256-vocab one) from the draw provider ``draws``; a VLM model's trace
    carries ``n_patches`` patch embeddings per request."""
    r = cfg.n_requests
    u = draws.uniform("serve.arrival", (r,), 0.0, 1.0).double().cpu().numpy()
    gen = cfg.min_gen + draws.randint("serve.gen_len", (r,), cfg.max_gen - cfg.min_gen + 1)
    vocab = int(model_cfg.vocab_size) if model_cfg is not None else 256
    prompts = draws.randint("serve.prompts", (r, cfg.prompt_len), vocab)
    patch_embeds = None
    if model_cfg is not None and model_cfg.family.name == "VLM":
        patch_embeds = draws.normal("serve.patches", (r, n_patches, model_cfg.d_model)).to(
            getattr(torch, model_cfg.compute_dtype)).float().cpu().numpy()
    return trace_from_arrays(_arrival_times(u, cfg), gen.cpu().numpy(),
                             prompts.cpu().numpy(), cfg.slo_ms, patch_embeds)
