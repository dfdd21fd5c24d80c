"""Public entry points of the delta-pipeline kernel family.

A CPU tensor goes to the plain version (``ref.py``), a CUDA tensor to the
hand-written kernel (``delta_pipeline.py``); anything else raises. There
is no fallback: a CUDA tensor whose kernel cannot build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.delta_pipeline.delta_pipeline import (
    delta_pipeline_apply_cuda,
    delta_pipeline_partial_cuda,
    delta_sq_norms_cuda,
)
from repro_torch.kernels.delta_pipeline.ref import (
    delta_pipeline_partial_ref,
    delta_pipeline_ref,
    delta_sq_norms_ref,
)


def _route(t: torch.Tensor, cpu_fn, cuda_fn):
    if t.device.type == "cpu":
        return cpu_fn
    if t.device.type == "cuda":
        return cuda_fn
    raise ValueError(f"no delta-pipeline kernel for device {t.device}")


def delta_sq_norms(updates: torch.Tensor) -> torch.Tensor:
    """Per-client Σx² over the fused (C, P) delta buffer -> (C,)."""
    return _route(updates, delta_sq_norms_ref, delta_sq_norms_cuda)(updates)


def delta_pipeline_apply(updates: torch.Tensor, *args, **kwargs):
    """One-pass fused delta pipeline over the (C, P) buffer; the signature
    of ``repro.kernels.delta_pipeline.delta_pipeline_apply`` without its
    Pallas tiling arguments."""
    fn = _route(updates, delta_pipeline_ref, delta_pipeline_apply_cuda)
    return fn(updates, *args, **kwargs)


def delta_pipeline_partial(updates: torch.Tensor, dm: torch.Tensor, **kwargs):
    """One fog's pass: clip + compression + UNnormalized Σ dm_i·x_i over
    its (C_local, P) block -> (P,); the signature of
    ``repro.kernels.delta_pipeline.delta_pipeline_partial`` without its
    Pallas tiling arguments."""
    fn = _route(updates, delta_pipeline_partial_ref, delta_pipeline_partial_cuda)
    return fn(updates, dm, **kwargs)
