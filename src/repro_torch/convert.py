"""Carry parameters and simulator / FL state from the JAX package into
the port.

Every function takes numpy arrays (anything ``np.asarray`` accepts), never
JAX objects by type, so a test can run ``repro``'s ``init_state(seed)``
or ``init_fl_state``, hand the arrays over, and start both packages from
one state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import (
    ClientTelemetry,
    PopulationSchedulerState,
    SchedulerState,
)
from repro_torch.data.telemetry import DeviceProfiles
from repro_torch.device import resolve_device


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x, copy=True), dtype=dtype, device=device)


def params_from_jax(params, device=None):
    """A list of ``{"w", "b"}`` numpy layers -> the port's parameters, on
    the CUDA card unless ``device`` names another."""
    device = resolve_device(device)
    return [{"w": _t(l["w"], device), "b": _t(l["b"], device)} for l in params]


def _get(obj, name):
    return obj.get(name) if isinstance(obj, dict) else getattr(obj, name, None)


def _fields(obj, names, device):
    return {k: _t(_get(obj, k), device) for k in names}


def state_from_jax(env, sched_state, telemetry, device=None):
    """(env, sched_state, telemetry) of ``repro``'s ``init_state`` —
    objects or dicts whose fields are numpy arrays — -> the port's, on the
    CUDA card unless ``device`` names another. A population state (its
    scheduler rows carry ``last_hist_round`` and no ``prev_hist``) becomes
    a ``PopulationSchedulerState`` beside the (M,)-row env and telemetry."""
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
    rows = ("theta_e", "warm", "last_used", "energy_spent")
    if _get(sched_state, "last_hist_round") is not None:
        sched = PopulationSchedulerState(**_fields(
            sched_state, rows + ("last_hist_round", "round_index"), device
        ))
    else:
        sched = SchedulerState(**_fields(
            sched_state, ("prev_hist",) + rows + ("round_index",), device
        ))
    tel = ClientTelemetry(**_fields(telemetry, ("cpu", "mem", "batt", "energy"), device))
    return new_env, sched, tel


def _tensor_tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through float32
        return torch.as_tensor(a.astype(np.float32), device=device).to(torch.bfloat16)
    return _t(a, device)


def model_params_from_jax(cfg, params, device=None):
    """The JAX package's LM parameter tree (``Model.init``; leaves numpy or
    anything ``np.asarray`` takes) -> the port's, on the CUDA card unless
    ``device`` names another. Both packages keep one layout (``wq`` as
    (L, d, H, hd) and so on), so each leaf carries over as it is, in its
    own dtype (rwkv6's ``decay`` and ``u``, hymba's ``ssm_a_log``,
    ``ssm_d`` and ``ssm_dt_bias`` are float32 in a bf16 tree); the tree
    is checked against the declarations of ``cfg``'s family (seamless's
    ``enc_layers`` / ``dec_layers`` with its ``x_`` cross-attention
    leaves included), in keys, shapes and dtypes."""
    from repro_torch.models.api import decls as family_decls

    device = resolve_device(device)
    out = _tensor_tree(params, device)
    decls = family_decls(cfg)

    def check(d, t, path):
        if set(d) != set(t):
            raise ValueError(f"{path or 'params'}: keys {sorted(t)} != {sorted(d)}")
        for k in d:
            if isinstance(d[k], dict):
                check(d[k], t[k], f"{path}/{k}")
            elif tuple(t[k].shape) != d[k].shape:
                raise ValueError(f"{path}/{k}: shape {tuple(t[k].shape)} != {d[k].shape}")
            elif t[k].dtype != getattr(torch, d[k].dtype):
                raise ValueError(f"{path}/{k}: dtype {t[k].dtype} != {d[k].dtype}")

    check(decls, out, "")
    return out


def fl_state_from_jax(cfg, state, device=None):
    """A JAX ``FLState`` (an object or dict whose leaves are numpy arrays:
    model params, ``server_mu`` or None, ``server_count``, a dense or
    full-population ``SchedulerState``, ``rng``, ``step``) -> the port's
    ``fl.state.FLState``, on the CUDA card unless ``device`` names
    another. ``rng`` stays a host (2,) uint32 key and ``step`` a host int,
    as the port keeps them."""
    from repro_torch.fl.state import FLState

    device = resolve_device(device)
    mu = _get(state, "server_mu")
    sched = _get(state, "sched")
    return FLState(
        params=model_params_from_jax(cfg, _get(state, "params"), device),
        server_mu=None if mu is None else _tensor_tree(mu, device),
        server_count=_t(_get(state, "server_count"), device, torch.int32),
        sched=SchedulerState(**_fields(
            sched, ("prev_hist", "theta_e", "warm", "last_used", "energy_spent",
                    "round_index"), device)),
        rng=np.array(_get(state, "rng"), dtype=np.uint32),
        step=int(np.asarray(_get(state, "step"))),
    )


def shard_params(cfg, params, rules, device=None):
    """The JAX package's LM parameter tree (numpy leaves) -> this rank's
    blocks under mesh ``rules`` (``ShardingRules.tensor_specs``), on the
    CUDA card unless ``device`` names another."""
    from repro_torch.models.api import decls as family_decls

    whole = model_params_from_jax(cfg, params, device="cpu")
    blocks = rules.shard_tree(whole, family_decls(cfg))
    device = resolve_device(device)
    return _tree_to(blocks, device)


def whole_params(cfg, blocks, rules):
    """The inverse of :func:`shard_params`: ``blocks[j]``, member j's blocks
    (``ShardingRules.member_coords``), -> the whole tree as numpy arrays
    in the JAX package's layout (bf16 leaves widened to float32)."""
    from repro_torch.models.api import decls as family_decls

    whole = rules.assemble([_tree_to(b, "cpu") for b in blocks], family_decls(cfg))
    return _tree_numpy(whole)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
