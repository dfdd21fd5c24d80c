"""Discrete-event cost model for one FL round, §IV.F / Table IX (port of
``repro/sim/des.py``: ``FaasSimConfig``, ``RoundCosts``,
``RoundCostModel``). Pure arithmetic on (N,) masks and profiles.

Per selected client i (§IV.F):

    t_i = δ_i + workload/MIPS_i + up/bw_up_i + down/bw_down_i + RTT_i
          + orchestration share
    round latency = max_{i ∈ C_t} t_i
    E_i = C_cpu·cycles + C_tx·TX_bytes (+ e_c per cold start)
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.coldstart import ColdStartConfig
from repro_torch.core.energy import EnergyModelConfig
from repro_torch.device import scalar

Array = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FaasSimConfig:
    cold_start: ColdStartConfig = dataclasses.field(default_factory=ColdStartConfig)
    energy: EnergyModelConfig = dataclasses.field(default_factory=EnergyModelConfig)
    dispatch_ms: float = 1.5  # per scheduled client (FedFog O(K))
    sort_ms_per_nlogn: float = 0.02  # FedFog priority queue per N·log2(N)
    deploy_ms: float = 2.0  # FogFaaS per-deployment
    poll_ms: float = 0.08  # FogFaaS per (deployment × active) status poll


class RoundCosts(NamedTuple):
    """Everything the DES accounts for in one synchronous round."""

    per_client_ms: Array  # (N,) — 0 for unselected clients
    round_ms: Array  # () straggler-defined round latency
    orchestration_ms: Array  # () scheduler/platform overhead
    energy_j: Array  # (N,) — 0 for unselected clients
    cold_starts: Array  # () int32 — selected clients paying δ_cold


def _f32(x: float, like: Array) -> Array:
    """A Python scalar as a 0-d float32 tensor on ``like``'s device, so
    ``scalar / tensor`` divides (torch's reflected division multiplies by a
    reciprocal instead). Made by a fill kernel (``device.scalar``), not
    copied from the host, so a round does not wait for the device queue."""
    return scalar(x, like.device)


@dataclasses.dataclass(frozen=True)
class RoundCostModel:
    """The shared §IV.F cost model, parameterized by ``FaasSimConfig``."""

    cfg: FaasSimConfig = dataclasses.field(default_factory=FaasSimConfig)

    @classmethod
    def from_scheduler(cls, sched_cfg) -> "RoundCostModel":
        """Build from a ``SchedulerConfig``: the LM round's entry point, so
        both engines derive §IV.F semantics from one place."""
        return cls(FaasSimConfig(cold_start=sched_cfg.cold_start,
                                 energy=sched_cfg.energy_model))

    def orchestration_ms(self, n: int, k: Array, policy: str = "fedfog") -> Array:
        """Platform overhead for one round (Table IX); ``k`` is the number
        of selected clients."""
        if policy == "fedfog":
            log2n = torch.log2(_f32(float(max(n, 2)), k))
            return self.cfg.sort_ms_per_nlogn * n * log2n + self.cfg.dispatch_ms * k
        return _f32(self.cfg.deploy_ms * n + self.cfg.poll_ms * n * n, k)

    def times_ms(
        self, profiles, selected: Array, warm: Array, workload_flops: float,
        upload_bytes: float, download_bytes: float, policy: str = "fedfog",
    ) -> tuple[Array, Array, Array]:
        """Returns (per_client_ms (N,), round_ms (), orchestration_ms ())."""
        n = selected.shape[0]
        k = torch.sum(selected.to(torch.float32))
        t_compute = _f32(workload_flops, k) / profiles.mips * 1e3
        t_net = (
            _f32(upload_bytes, k) / profiles.bw_up
            + _f32(download_bytes, k) / profiles.bw_down
        ) * 1e3 + profiles.rtt_ms
        delta = torch.where(
            warm,
            _f32(self.cfg.cold_start.delta_warm_ms, k),
            _f32(self.cfg.cold_start.delta_cold_ms, k),
        )
        orch = self.orchestration_ms(n, k, policy)
        per_client = (
            delta + t_compute + t_net + orch / torch.clamp(k, min=1.0)
        ) * selected
        round_ms = torch.max(
            torch.where(selected, per_client, torch.zeros_like(per_client))
        )
        return per_client, round_ms, orch

    def energy_j(
        self, selected: Array, warm: Array, workload_flops: float,
        upload_bytes: float,
    ) -> Array:
        """(N,) Joules for the round: compute + uplink + cold-start (§IV.F)."""
        e = self.cfg.energy
        fixed = e.c_cpu * workload_flops + e.c_tx * upload_bytes  # Python floats
        return (fixed + (~warm) * e.cold_start_energy_j) * selected

    # -- serving: the host-driven engine keeps its virtual clock on the
    # host, so these return plain floats from the same §IV.F constants.
    def invocation_delay_ms(self, warm: bool) -> float:
        """Eq. 4 container delay for ONE serving invocation (a prefill)."""
        cs = self.cfg.cold_start
        return float(cs.delta_warm_ms if warm else cs.delta_cold_ms)

    def token_energy_j(self, flops: float, tx_bytes: float = 0.0) -> float:
        """§IV.F energy for ``flops`` of compute + ``tx_bytes`` streamed out."""
        e = self.cfg.energy
        return float(e.c_cpu * flops + e.c_tx * tx_bytes)

    def cold_start_energy_j(self) -> float:
        """e_c in §IV.F, paid by each cold serving prefill."""
        return float(self.cfg.energy.cold_start_energy_j)

    def round_costs(
        self, profiles, selected: Array, warm: Array, workload_flops: float,
        upload_bytes: float, download_bytes: float, policy: str = "fedfog",
    ) -> RoundCosts:
        """One call = the complete DES accounting for one round."""
        per_client, round_ms, orch = self.times_ms(
            profiles, selected, warm, workload_flops, upload_bytes,
            download_bytes, policy,
        )
        return RoundCosts(
            per_client_ms=per_client,
            round_ms=round_ms,
            orchestration_ms=orch,
            energy_j=self.energy_j(selected, warm, workload_flops, upload_bytes),
            cold_starts=torch.sum((selected & ~warm).to(torch.int32)),
        )


