"""Serverless (FaaS) execution model — the function-style façade (port of
``repro/sim/faas.py``).

The §IV.F formulas live in ``repro_torch.sim.des.RoundCostModel``; these
are thin delegating wrappers kept for the original API.
``round_times_ms`` returns a fully masked ``per_client`` vector:
unselected clients report 0 ms.
"""
from __future__ import annotations

import torch

from repro_torch.data.telemetry import DeviceProfiles
from repro_torch.sim.des import FaasSimConfig, RoundCostModel

__all__ = ["FaasSimConfig", "round_energy_j", "round_times_ms"]

Array = torch.Tensor


def round_times_ms(
    cfg: FaasSimConfig,
    profiles: DeviceProfiles,
    selected: Array,  # (N,) bool
    warm: Array,  # (N,) bool
    workload_flops: Array | float,
    upload_bytes: Array | float,
    download_bytes: Array | float,
    policy: str = "fedfog",
):
    """Returns (per_client_ms (N,), round_ms (), orchestration_ms ())."""
    return RoundCostModel(cfg).times_ms(
        profiles, selected, warm, workload_flops, upload_bytes, download_bytes, policy,
    )


def round_energy_j(
    cfg: FaasSimConfig,
    profiles: DeviceProfiles,
    selected: Array,
    warm: Array,
    workload_flops: Array | float,
    upload_bytes: Array | float,
):
    """Per-client Joules for the round (§IV.F energy model)."""
    del profiles  # energy constants are profile-independent in sim units
    return RoundCostModel(cfg).energy_j(selected, warm, workload_flops, upload_bytes)
