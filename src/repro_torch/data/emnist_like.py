"""EMNIST-like synthetic vision task, batched over clients (port of
``repro/data/emnist_like.py``).

Deterministic 28×28 "characters": each of the 62 classes is a smooth
template (7×7 normals upsampled bilinearly, then tanh); samples are
template + Gaussian pixel noise. Clients get Dirichlet non-IID label
priors; drift re-draws a client's prior and permutes its labels (concept
drift). Where the JAX functions take one ``client_id`` and a key, these
take the draw provider and return all ``n`` clients at once.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.random import flush_context

IMG = 28


@dataclasses.dataclass(frozen=True)
class EmnistLikeConfig:
    num_classes: int = 62
    dirichlet_alpha: float = 0.5
    drift_period: int = 0
    drift_fraction: float = 0.3
    noise: float = 0.35
    seed: int = 0


def _templates(cfg: EmnistLikeConfig, draws) -> torch.Tensor:
    """(K, 28, 28) smooth class templates.

    ``F.interpolate(bilinear, align_corners=False)`` is the half-pixel
    resampling of ``jax.image.resize(..., "bilinear")``; for upsampling
    neither antialiases, and both clamp at the border.
    """
    coarse = draws.normal("templates", (cfg.num_classes, 7, 7))
    up = F.interpolate(
        coarse[:, None], size=(IMG, IMG), mode="bilinear",
        align_corners=False, antialias=False,
    )[:, 0]
    return torch.tanh(up * 2.0)


def _drift_epoch(cfg, draws, n: int, round_idx, ids=None, site="drift.flags"):
    """(epoch, flags): the drift epoch of ``round_idx`` (an int, or an (n,)
    tensor for per-client rounds) and the (n,) bool mask of clients
    drifted in it, drawn from ``site``. A client's effective epoch is
    ``epoch`` where flagged, else 0 (undrifted). ``flags`` is None when no
    client can be drifted (drift off, or an int round in epoch 0)."""
    if not cfg.drift_period:
        return 0, None
    if isinstance(round_idx, torch.Tensor):
        epoch = torch.div(round_idx.to(torch.int64), cfg.drift_period,
                          rounding_mode="floor")
    else:
        epoch = int(round_idx) // cfg.drift_period
        if epoch == 0:
            return 0, None
    return epoch, draws.bernoulli(
        site, cfg.drift_fraction, (n,), epoch=epoch, ids=ids
    )


def _effective_epoch(cfg, draws, n, round_idx, ids, site="drift.flags"):
    """(n,) int64 effective drift epochs, or None when none can be > 0."""
    epoch, flags = _drift_epoch(cfg, draws, n, round_idx, ids, site)
    if flags is None:
        return None
    return torch.where(flags, epoch, 0)


def _prior(cfg, draws, n, eff, ids, site="prior"):
    return draws.dirichlet(
        site, cfg.dirichlet_alpha, (n, cfg.num_classes), ids=ids,
        epoch=0 if eff is None else eff,
    )


def client_label_prior(cfg: EmnistLikeConfig, draws, n: int, round_idx, ids=None):
    """(n, K) label priors: Dirichlet draws keyed by (seed, client id,
    effective drift epoch), so every round of an epoch, and every cohort,
    sees the same one."""
    return _prior(cfg, draws, n, _effective_epoch(cfg, draws, n, round_idx, ids), ids)


def client_batch(
    cfg: EmnistLikeConfig, draws, n: int, round_idx: int, batch: int,
    templates: torch.Tensor, ids=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (images (n, batch, 784) f32, labels (n, batch) int64).

    Drifted clients see their labels permuted by their epoch's permutation
    (concept drift, §IV.A), which is what Eq. 2's gate must detect."""
    eff = _effective_epoch(cfg, draws, n, round_idx, ids)
    prior = _prior(cfg, draws, n, eff, ids)
    labels = draws.categorical(
        "client_batch.labels", torch.log(prior + 1e-9), batch, round=round_idx,
        ids=ids,
    )
    noise = draws.normal(
        "client_batch.noise", (n, batch, IMG * IMG), round=round_idx, ids=ids
    )
    temps = templates.reshape(cfg.num_classes, IMG * IMG)[labels]
    imgs = temps + noise * cfg.noise
    if eff is not None:
        perm = draws.permutation("drift.perm", cfg.num_classes, epoch=eff)
        labels = torch.where(eff[:, None] > 0, torch.gather(perm, 1, labels), labels)
    return imgs.to(torch.float32), labels


def client_histogram(cfg: EmnistLikeConfig, draws, n: int, round_idx, ids=None):
    """(n, K) exact OBSERVED label distributions — the Eq. 2 drift signal
    (the drift permutation applied to the prior)."""
    eff = _effective_epoch(cfg, draws, n, round_idx, ids)
    prior = _prior(cfg, draws, n, eff, ids)
    if eff is None:
        return prior
    perm = draws.permutation("drift.perm", cfg.num_classes, epoch=eff)
    permuted = torch.zeros_like(prior).scatter(1, perm, prior)
    return torch.where(eff[:, None] > 0, permuted, prior)


def eval_batch(
    cfg: EmnistLikeConfig, draws, round_idx: int, batch: int,
    templates: torch.Tensor, uses: int = 0,
):
    """IID test split (uniform labels): (images (batch, 784), labels);
    ``uses`` keys a repeat flush's batch (``random.flush_context``)."""
    ctx = flush_context(round_idx, uses)
    labels = draws.randint("eval.labels", (batch,), cfg.num_classes, **ctx)
    noise = draws.normal("eval.noise", (batch, IMG * IMG), **ctx)
    temps = templates.reshape(cfg.num_classes, IMG * IMG)[labels]
    return (temps + noise * cfg.noise).to(torch.float32), labels
