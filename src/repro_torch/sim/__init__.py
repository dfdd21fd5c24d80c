"""Simulation stack of the port: the shared §IV.F cost model and the
sweep runner.

    des.py   — ``RoundCostModel``, the latency / energy / cold-start model
               of both engines.
    faas.py  — ``round_times_ms`` / ``round_energy_j``, its function-style
               façade.
    sweep.py — ``run_sweep``: config grid × seed batch over the scanned
               engine or the event-driven one (``engine="async"``).
    events/  — the event-driven asynchronous engine. Imported as
               ``repro_torch.sim.events`` and not re-exported here: its
               engine imports ``repro_torch.fl.simulator``, which imports
               ``repro_torch.sim.des``, and the package import must not
               close that cycle.
"""
from repro_torch.sim.des import FaasSimConfig, RoundCostModel, RoundCosts
from repro_torch.sim.faas import round_energy_j, round_times_ms
from repro_torch.sim.sweep import SweepResult, run_sweep

__all__ = ["FaasSimConfig", "RoundCostModel", "RoundCosts", "SweepResult",
           "round_energy_j", "round_times_ms", "run_sweep"]
