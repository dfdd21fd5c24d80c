"""Carry parameters and simulator state from the JAX package into the port.

Both functions take numpy arrays (anything ``np.asarray`` accepts), never
JAX objects by type, so a test can run ``repro``'s ``init_state(seed)``,
hand the arrays over, and start both simulators from one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import ClientTelemetry, SchedulerState
from repro_torch.data.telemetry import DeviceProfiles
from repro_torch.device import resolve_device


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype, device=device)


def params_from_jax(params, device=None):
    """A list of ``{"w", "b"}`` numpy layers -> the port's parameters, on
    the CUDA card unless ``device`` names another."""
    device = resolve_device(device)
    return [{"w": _t(l["w"], device), "b": _t(l["b"], device)} for l in params]


def _fields(obj, names, device):
    get = obj.get if isinstance(obj, dict) else lambda k: getattr(obj, k)
    return {k: _t(get(k), device) for k in names}


def state_from_jax(env, sched_state, telemetry, device=None):
    """(env, sched_state, telemetry) of ``repro``'s dense ``init_state`` —
    objects or dicts whose fields are numpy arrays — -> the port's, on the
    CUDA card unless ``device`` names another."""
    device = resolve_device(device)
    prof = env["profiles"]
    profiles = DeviceProfiles(**_fields(
        prof, ("mips", "bw_up", "bw_down", "rtt_ms", "battery_capacity_j"), device
    ))
    new_env = {
        "profiles": profiles,
        "data_sizes": _t(env["data_sizes"], device, torch.float32),
        "malicious": _t(env["malicious"], device, torch.bool),
        "data_seed": int(np.asarray(env["data_seed"])),
    }
    sched = SchedulerState(**_fields(
        sched_state,
        ("prev_hist", "theta_e", "warm", "last_used", "energy_spent", "round_index"),
        device,
    ))
    tel = ClientTelemetry(**_fields(telemetry, ("cpu", "mem", "batt", "energy"), device))
    return new_env, sched, tel
