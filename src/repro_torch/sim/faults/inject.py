"""Fault realization of the synchronous round (port of
``repro/sim/faults/inject.py``).

The sync round has no event clock, so a round's whole failure and retry
history is emulated as a chain of masked attempts whose latency, energy
and counters fold into the §IV.F totals:

  * attempt a of an admitted client fails on cold-start timeout
    (attempt 0 and a cold container only), crash, drop, or the round's
    transient partition (attempt 0 only: retries land after it heals);
  * a failed attempt below the retry cap re-runs after exponential
    backoff and repays the full per-client §IV.F latency and energy;
  * a fog outage takes its edge clients' arrivals with it (Eq. 6 loses
    that partial sum) unless failover reroutes them at a latency detour;
  * arrivals after the server deadline are lost; a round below quorum is
    skipped (the caller carries the model over bitwise).

Every draw comes from the provider's ``faults.*`` sites keyed by the
round (and the attempt), so a faulted run replays from its seed. Python
branches only on the configuration (the retry cap, the failover flag,
the deadline's None-ness, and rates that are exactly 0, whose draws
could never fire); nothing here reads a device value back.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.types import static_on
from repro_torch.fl.fog import fog_assignment
from repro_torch.sim.faults.config import FaultConfig, backoff_ms

# Counter channels every round emits (zeros when faults are off, so
# histories keep one schema).
COUNTER_KEYS = (
    "fault_dispatched", "fault_completed", "fault_terminal", "fault_lost",
    "fault_retries", "fault_corrupt", "fog_outages", "fault_failed_over",
    "round_skipped",
)


def zero_counters(device) -> dict[str, torch.Tensor]:
    return {
        k: torch.zeros((), dtype=torch.int32, device=device) for k in COUNTER_KEYS
    }


class RoundFaultPlan(NamedTuple):
    """Realized faults of one sync round.

    arrived:  (N,) bool — admitted clients whose update reached the
              server (after outages and the deadline, before quorum).
    chain_ms: (N,) f32 — per-client wall latency of the whole attempt
              chain: every attempt's §IV.F latency, backoff waits and the
              failover detour. Zero outside the admitted clients.
    attempts: (N,) f32 — invocation attempts launched (the energy
              multiplier). Zero outside the admitted clients.
    corrupt:  (N,) bool — arrived but bit-rotted (noise added by the caller).
    skip:     () bool — below quorum: carry the model over bitwise.
    round_ms: () f32 — the longest admitted chain, clamped to the deadline.
    counters: dict of () int32 — the ``COUNTER_KEYS`` channels;
              dispatched = completed + terminal + lost.
    """

    arrived: torch.Tensor
    chain_ms: torch.Tensor
    attempts: torch.Tensor
    corrupt: torch.Tensor
    skip: torch.Tensor
    round_ms: torch.Tensor
    counters: dict


def _f32(x) -> float:
    """A configuration number rounded to float32, as the JAX package
    compares and adds it."""
    return float(np.float32(x))


def _fires(draws, site, rate, n, **ctx):
    """(n,) bool ``uniform < rate`` from ``site``, or None when the rate
    is exactly 0 (such a draw never fires, so it is not made)."""
    if not static_on(rate):
        return None
    return draws.uniform(site, (n,), 0.0, 1.0, **ctx) < _f32(rate)


def attempt_failures(
    fc: FaultConfig, draws, alive: torch.Tensor, cold: torch.Tensor,
    part_cut: torch.Tensor | None, attempt: int, *, round: int, attempts: int,
    prefix: str = "faults",
) -> torch.Tensor:
    """(N,) bool — which still-alive invocations fail on this attempt
    (``attempt`` of ``attempts``, 0-based), from the ``<prefix>.crash``,
    ``.drop`` and ``.timeout`` sites (``async.faults`` for the first
    attempts of an async dispatch)."""
    n = alive.shape[0]
    ctx = dict(round=round, index=attempt, attempts=attempts)
    fail = torch.zeros_like(alive)
    for site, rate in (("crash", fc.crash_rate), ("drop", fc.drop_rate)):
        f = _fires(draws, f"{prefix}.{site}", rate, n, **ctx)
        if f is not None:
            fail = fail | f
    if attempt == 0:
        f = _fires(draws, f"{prefix}.timeout", fc.timeout_rate, n, **ctx)
        if f is not None:
            fail = fail | (cold & f)
        if part_cut is not None:
            fail = fail | part_cut
    return alive & fail


def plan_round(
    fc: FaultConfig,
    draws,
    admitted: torch.Tensor,  # (N,) bool — post-scheduler cohort
    cold: torch.Tensor,  # (N,) bool — invocation hits a cold container
    per_client_ms: torch.Tensor,  # (N,) f32 — one attempt's §IV.F latency
    fog_nodes: int = 1,
    *,
    round: int,
) -> RoundFaultPlan:
    """Realize one round's faults and recovery."""
    n = admitted.shape[0]
    dev = admitted.device
    i32, f32 = torch.int32, torch.float32

    # Transient partition: one gate per round times a random subset.
    part_cut = None
    if static_on(fc.partition_rate):
        part_on = (draws.uniform("faults.partition", (), 0.0, 1.0, round=round)
                   < _f32(fc.partition_rate))
        part_cut = part_on & (
            draws.uniform("faults.partition_frac", (n,), 0.0, 1.0, round=round)
            < _f32(fc.partition_frac))

    # The retry chain, unrolled: attempt 0 and max_retries retries.
    cap = int(fc.max_retries)
    alive = admitted
    arrived = torch.zeros((n,), dtype=torch.bool, device=dev)
    chain = torch.zeros((n,), dtype=f32, device=dev)
    attempts = torch.zeros((n,), dtype=f32, device=dev)
    n_retries = torch.zeros((), dtype=i32, device=dev)
    for a in range(cap + 1):
        fail = attempt_failures(fc, draws, alive, cold, part_cut, a,
                                round=round, attempts=cap + 1)
        chain = chain + torch.where(alive, per_client_ms, 0.0)
        attempts = attempts + alive.to(f32)
        arrived = arrived | (alive & ~fail)
        if a < cap:
            wait = backoff_ms(fc, a + 1)  # a host float, from the config
            chain = chain + torch.where(fail, wait, 0.0)
            n_retries = n_retries + torch.sum(fail).to(i32)
            alive = fail
        else:
            terminal = fail  # failed on the last attempt allowed

    # Fog outage: each fog goes dark independently; its contiguous block
    # of clients (fl.fog.fog_assignment, the kernel path's layout) loses
    # its arrivals or reroutes them. A single tier is the cloud uplink.
    n_outages = torch.zeros((), dtype=i32, device=dev)
    n_failed_over = torch.zeros((), dtype=i32, device=dev)
    n_lost = torch.zeros((), dtype=i32, device=dev)
    fogs = max(int(fog_nodes), 1)
    if fogs > 1 and static_on(fc.fog_outage_rate):
        outage = (draws.uniform("faults.fog", (fogs,), 0.0, 1.0, round=round)
                  < _f32(fc.fog_outage_rate))
        n_outages = torch.sum(outage).to(i32)
        dark = torch.index_select(outage, 0, fog_assignment(n, fogs, dev)) & arrived
        if bool(fc.fog_failover):
            chain = chain + torch.where(dark, _f32(fc.failover_latency_ms), 0.0)
            n_failed_over = torch.sum(dark).to(i32)
        else:
            arrived = arrived & ~dark
            n_lost = n_lost + torch.sum(dark).to(i32)

    # Server deadline: later arrivals are lost; the round never runs
    # longer than the deadline.
    round_ms = torch.max(torch.where(admitted, chain, 0.0))
    if fc.deadline_ms is not None:
        deadline = _f32(fc.deadline_ms)
        late = arrived & (chain > deadline)
        arrived = arrived & ~late
        n_lost = n_lost + torch.sum(late).to(i32)
        round_ms = torch.clamp(round_ms, max=deadline)

    # Corrupted-but-arrived payloads (noise added by the caller).
    corrupt = _fires(draws, "faults.corrupt", fc.corrupt_rate, n, round=round)
    corrupt = torch.zeros_like(arrived) if corrupt is None else arrived & corrupt

    # Quorum: aggregate the arrivals iff enough of the cohort arrived. An
    # empty arrival set always skips: Eq. 6 has no denominator.
    n_adm = torch.sum(admitted).to(i32)
    n_arr = torch.sum(arrived).to(i32)
    quorum = _f32(fc.quorum_frac) * n_adm.to(f32)
    skip = (n_arr.to(f32) < quorum) | ((n_arr == 0) & (n_adm > 0))

    counters = {
        "fault_dispatched": n_adm,
        "fault_completed": n_arr,
        "fault_terminal": torch.sum(terminal).to(i32),
        "fault_lost": n_lost,
        "fault_retries": n_retries,
        "fault_corrupt": torch.sum(corrupt).to(i32),
        "fog_outages": n_outages,
        "fault_failed_over": n_failed_over,
        "round_skipped": skip.to(i32),
    }
    return RoundFaultPlan(
        arrived=arrived,
        chain_ms=torch.where(admitted, chain, 0.0),
        attempts=attempts,
        corrupt=corrupt,
        skip=skip,
        round_ms=round_ms,
        counters=counters,
    )
