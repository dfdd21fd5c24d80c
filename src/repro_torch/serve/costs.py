"""Virtual-clock cost model for the serving engine (port of
``repro/serve/costs.py``).

The continuous-batching loop is host-driven, so these return plain
floats; every §IV.F constant comes from the same ``FaasSimConfig``
(``repro_torch.sim.des``) as the FL round accounting:

  * a prefill is one serverless invocation: the Eq. 4 container delay
    (cold after ``keep_alive_ms`` idle, warm otherwise) plus prompt
    compute;
  * a decode step costs a fixed weight-streaming floor plus the active
    slots' marginal flops.
"""
from __future__ import annotations

import dataclasses

from repro_torch.sim.des import FaasSimConfig, RoundCostModel


@dataclasses.dataclass(frozen=True)
class ServeCostModel:
    cost: RoundCostModel = dataclasses.field(default_factory=RoundCostModel)
    flops_per_s: float = 1e12  # accelerator throughput (sim units)
    step_overhead_ms: float = 5.0  # per-decode-step weight streaming floor
    keep_alive_ms: float = 500.0  # container cache window (Eq. 4 gate)
    tx_bytes_per_token: float = 8.0  # tokens streamed back to the client

    @classmethod
    def from_faas(cls, cfg: FaasSimConfig, **kw) -> "ServeCostModel":
        return cls(cost=RoundCostModel(cfg), **kw)

    def prefill_ms(self, prompt_flops: float, warm: bool) -> float:
        """One admission: container delay (Eq. 4) + prompt compute."""
        return self.cost.invocation_delay_ms(warm) + prompt_flops / self.flops_per_s * 1e3

    def decode_step_ms(self, active_flops: float) -> float:
        """One batched decode step over however many slots are live."""
        return self.step_overhead_ms + active_flops / self.flops_per_s * 1e3

    def prefill_energy_j(self, prompt_flops: float, warm: bool) -> float:
        e = self.cost.token_energy_j(prompt_flops)
        return e if warm else e + self.cost.cold_start_energy_j()

    def step_energy_j(self, active_flops: float, n_tokens: int) -> float:
        """Compute + per-token egress for one decode step (§IV.F E_i)."""
        return self.cost.token_energy_j(
            active_flops, tx_bytes=self.tx_bytes_per_token * n_tokens
        )
