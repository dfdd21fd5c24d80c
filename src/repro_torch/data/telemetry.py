"""Device telemetry simulator (port of ``repro/data/telemetry.py``): the
CPU/MEM/BATT/energy signals behind Eq. 1 and Eq. 3, with AR(1) load
fluctuations, participation-driven battery drain and heterogeneous
device classes."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import ClientTelemetry
from repro_torch.random import flush_context

Array = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    num_clients: int = 64
    ar_rho: float = 0.8  # AR(1) persistence for cpu/mem
    ar_noise: float = 0.12
    drain_per_round: float = 0.06  # battery drain when participating
    recharge: float = 0.01
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class DeviceProfiles:
    """Static heterogeneity: (N,) tensors."""

    mips: Array  # compute capacity, instructions/s (sim units)
    bw_up: Array  # uplink bytes/s
    bw_down: Array  # downlink bytes/s
    rtt_ms: Array
    battery_capacity_j: Array


def _table(values, cls: Array) -> Array:
    return torch.tensor(values, dtype=torch.float32, device=cls.device)[cls]


def make_profiles(cfg: TelemetryConfig, draws) -> DeviceProfiles:
    n = cfg.num_clients
    # device class mix: 0=wearable, 1=camera, 2=gateway-adjacent sensor
    cls = draws.randint("profiles.class", (n,), 3)
    mips = _table([500e6, 1200e6, 800e6], cls) * (
        1.0 + 0.3 * draws.normal("profiles.mips", (n,))
    )
    bw_up = _table([1e6, 5e6, 2e6], cls) * torch.exp(
        0.3 * draws.normal("profiles.bw_up", (n,))
    )
    rtt = _table([40.0, 15.0, 25.0], cls) * torch.exp(
        0.2 * draws.normal("profiles.rtt", (n,))
    )
    return DeviceProfiles(
        mips=torch.abs(mips) + 1e5,
        bw_up=bw_up,
        bw_down=bw_up * 4,
        rtt_ms=rtt,
        battery_capacity_j=_table([8e3, 40e3, 15e3], cls),
    )


def init_telemetry(cfg: TelemetryConfig, draws) -> ClientTelemetry:
    n = cfg.num_clients
    u = lambda site: draws.uniform(site, (n,), 0.4, 1.0)  # noqa: E731
    cpu, mem = u("telemetry.init.cpu"), u("telemetry.init.mem")
    batt = u("telemetry.init.batt")
    return ClientTelemetry(cpu=cpu, mem=mem, batt=batt, energy=batt)


def step_telemetry(
    cfg: TelemetryConfig,
    tel: ClientTelemetry,
    participated: Array,  # (N,) bool
    round_energy_j: Array,  # (N,)
    profiles: DeviceProfiles,
    draws,
    *,
    round: int,
    uses: int = 0,
) -> ClientTelemetry:
    z = draws.normal("telemetry.ar", (2, cfg.num_clients),
                     **flush_context(round, uses))

    def ar(x, noise):
        mean = 0.7
        return torch.clamp(
            mean + cfg.ar_rho * (x - mean) + noise * cfg.ar_noise, 0.05, 1.0
        )

    batt = torch.clamp(
        tel.batt
        - participated * cfg.drain_per_round
        - round_energy_j / profiles.battery_capacity_j
        + (~participated) * cfg.recharge,
        0.0,
        1.0,
    )
    return ClientTelemetry(
        cpu=ar(tel.cpu, z[0]), mem=ar(tel.mem, z[1]), batt=batt, energy=batt
    )
