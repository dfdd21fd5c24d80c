"""Core value types of the FedFog orchestration layer (port of
``repro/core/types.py``).

Everything is vectorized over a static client population of size ``N``.
Fields are tensors on the simulator's device; the dataclasses are frozen
and rebuilt with ``dataclasses.replace`` like their JAX counterparts.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device

Array = torch.Tensor


def static_on(x) -> bool:
    """Truthiness of a config scalar that gates a Python branch:
    ``x > 0`` for a concrete value, False for None. (The JAX package also
    answers True for sweep-lifted tracers; the port has no tracers.)"""
    return x is not None and bool(x > 0)


def static_any(*xs) -> bool:
    """``static_on`` over several gate scalars: True iff ANY is active
    (the single gate of a composite subsystem such as the fault layer)."""
    return any(static_on(x) for x in xs)


@dataclasses.dataclass(frozen=True)
class ClientTelemetry:
    """Raw per-client resource readings, each shape ``(N,)`` in [0, 1]:
    the Eq. 1 inputs plus the normalized energy level used by Eq. 3/7."""

    cpu: Array
    mem: Array
    batt: Array
    energy: Array

    @property
    def num_clients(self) -> int:
        return self.cpu.shape[0]


@dataclasses.dataclass(frozen=True)
class SchedulerWeights:
    """The (alpha, beta) weight vectors of Eq. 1 and Eq. 7."""

    alpha: Array  # (3,) health weights: cpu, mem, batt. Sum to 1.
    beta: Array  # (3,) utility weights: health, energy, drift. Sum to 1.


@dataclasses.dataclass(frozen=True)
class Thresholds:
    """Selection thresholds of Eq. 3. energy may be scalar or per-client (N,)."""

    health: Array
    energy: Array
    drift: Array


@dataclasses.dataclass(frozen=True)
class SchedulerState:
    """Carried across rounds by the scheduler.

    prev_hist:    (N, V) previous-round empirical distributions (Eq. 2 input).
    theta_e:      (N,) adaptive per-client energy thresholds (Eq. 10).
    warm:         (N,) bool — container warm/cold state (Eq. 4).
    last_used:    (N,) int32 — round index of last invocation.
    energy_spent: (N,) cumulative Joules (sim units) per client.
    round_index:  () int32.
    """

    prev_hist: Array
    theta_e: Array
    warm: Array
    last_used: Array
    energy_spent: Array
    round_index: Array


@dataclasses.dataclass(frozen=True)
class PopulationSchedulerState:
    """Population-scale scheduler registry: cheap ``(M,)`` rows only.

    Each round gathers a cohort-sized :class:`SchedulerState` from these
    rows (``fl.fog.gather_cohort_sched``) and scatters the advanced rows
    back. ``prev_hist`` is not stored (an (M, V) table is 248 MB at a
    million clients and 62 bins): ``last_hist_round`` records the round
    at which each client's histogram was last observed, and the drift
    reference is recomputed for the cohort only.

    theta_e:         (M,) adaptive per-client energy thresholds (Eq. 10).
    warm:            (M,) bool — container warm/cold state (Eq. 4).
    last_used:       (M,) int32 — round index of last invocation.
    energy_spent:    (M,) cumulative Joules (sim units) per client.
    last_hist_round: (M,) int32 — round the drift reference was taken at.
    round_index:     () int32.
    """

    theta_e: Array
    warm: Array
    last_used: Array
    energy_spent: Array
    last_hist_round: Array
    round_index: Array


@dataclasses.dataclass(frozen=True)
class SelectionResult:
    """Output of one scheduling decision (see ``repro.core.types``)."""

    mask: Array
    utility: Array
    health: Array
    drift: Array
    order: Array
    num_selected: Array


def init_scheduler_state(
    num_clients: int, hist_bins: int, theta_e0: float = 0.5, *, device=None
) -> SchedulerState:
    """Fresh scheduler state: uniform histograms, cold containers; on the
    CUDA card unless ``device`` names another."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return SchedulerState(
        prev_hist=torch.full((num_clients, hist_bins), 1.0 / hist_bins, **f32),
        theta_e=torch.full((num_clients,), theta_e0, **f32),
        warm=torch.zeros((num_clients,), dtype=torch.bool, device=device),
        last_used=torch.full(
            (num_clients,), -1, dtype=torch.int32, device=device
        ),
        energy_spent=torch.zeros((num_clients,), **f32),
        round_index=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_population_scheduler_state(
    population: int, theta_e0: float = 0.5, *, device=None
) -> PopulationSchedulerState:
    """Fresh population registry: cold containers, round-0 drift
    references; on the CUDA card unless ``device`` names another."""
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    return PopulationSchedulerState(
        theta_e=torch.full((population,), theta_e0, dtype=torch.float32, device=device),
        warm=torch.zeros((population,), dtype=torch.bool, device=device),
        last_used=torch.full((population,), -1, **i32),
        energy_spent=torch.zeros((population,), dtype=torch.float32, device=device),
        last_hist_round=torch.zeros((population,), **i32),
        round_index=torch.zeros((), **i32),
    )
