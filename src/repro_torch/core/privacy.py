"""Differential privacy accounting + Gaussian mechanism — paper Eq. 12
(port of ``repro/core/privacy.py``).

    ε = sqrt(2·log(1.25/δ)) / σ  ·  S / |C_t|
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class DPConfig:
    sigma: float = 0.3  # noise scale, relative to sensitivity
    sensitivity: float = 1.1  # S: update clip norm
    delta: float = 1e-5


def epsilon(sigma: float, sensitivity: float, num_clients, delta: float):
    """Eq. 12, verbatim."""
    c = math.sqrt(2.0 * math.log(1.25 / delta))
    return (c / sigma) * (sensitivity / num_clients)


def gaussian_mechanism(updates, draws, config: DPConfig, *, round: int):
    """Add N(0, (σ·S)²) noise to every leaf of an aggregated update tree.

    The normals come from the ``dp`` site, leaf by leaf in flatten order —
    the same block ``fl.fuse.fused_gaussian_noise`` draws, so the fused
    kernel path and this reference path add identical noise.
    """
    flat = tree.leaves(updates)
    sizes = tuple(l.numel() for l in flat)
    z = draws.normal("dp", (sum(sizes),), segments=sizes, round=round)
    std = config.sigma * config.sensitivity
    noisy, off = [], 0
    for l, n in zip(flat, sizes):
        part = z[off:off + n].reshape(l.shape)
        noisy.append(l + (std * part).to(l.dtype))
        off += n
    return tree.unflatten(updates, noisy)
