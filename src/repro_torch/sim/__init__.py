"""Simulation stack of the port: the shared §IV.F cost model."""
from repro_torch.sim.des import FaasSimConfig, RoundCostModel, RoundCosts

__all__ = ["FaasSimConfig", "RoundCostModel", "RoundCosts"]
