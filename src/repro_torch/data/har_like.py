"""HAR-like synthetic time-series task, batched over clients (port of
``repro/data/har_like.py``; the paper's Smart Healthcare scenario).

6 activity classes (as in UCI HAR), 9 channels (3×acc/gyro/total),
windows of 128 steps. Each class is a mixture of sinusoids with its own
per-channel frequency, amplitude and phase; each client adds its own
per-channel gain and phase offset (device placement), which with the
Dirichlet label priors makes the federation non-IID. Where the JAX
functions take one ``client_id`` and a key, these take the draw provider
and return all ``n`` clients at once.

The per-client sites (``har.prior``, ``har.drift.flags``, ``har.gain``,
``har.phase``) are keyed by client id, so a client is the same client in
every round and in whichever cohort of a population it lands.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.data.emnist_like import _effective_epoch, _prior
from repro_torch.random import flush_context

WINDOW = 128
CHANNELS = 9
NUM_CLASSES = 6


@dataclasses.dataclass(frozen=True)
class HarLikeConfig:
    dirichlet_alpha: float = 0.5
    drift_period: int = 0
    drift_fraction: float = 0.3
    noise: float = 0.3
    seed: int = 0

    @property
    def num_classes(self) -> int:
        return NUM_CLASSES


def _class_params(cfg: HarLikeConfig, draws):
    """Per-class per-channel (freq, amp, phase), each (K, CHANNELS)."""
    shape = (NUM_CLASSES, CHANNELS)
    freqs = draws.uniform("har.freqs", shape, 1.0, 8.0)
    amps = draws.uniform("har.amps", shape, 0.3, 1.2)
    phases = draws.uniform("har.phases", shape, 0.0, 2 * math.pi)
    return freqs, amps, phases


def _time_axis(device) -> torch.Tensor:
    """(WINDOW,) float32 ``linspace(0, 2π, WINDOW)`` as the JAX package
    computes it: ``i · (stop / (WINDOW - 1))`` in float32, the last step
    ``stop`` itself. Built on ``device`` without a host copy."""
    stop = np.float32(2 * math.pi)
    delta = float(stop / np.float32(WINDOW - 1))
    steps = torch.arange(WINDOW - 1, dtype=torch.float32, device=device) * delta
    return torch.cat([steps, torch.full((1,), float(stop), device=device)])


def client_label_prior(cfg: HarLikeConfig, draws, n: int, round_idx, ids=None):
    """(n, K) label priors of clients ``ids``, keyed by (seed, client id,
    effective drift epoch)."""
    eff = _effective_epoch(cfg, draws, n, round_idx, ids, site="har.drift.flags")
    return _prior(cfg, draws, n, eff, ids, site="har.prior")


def client_batch(cfg: HarLikeConfig, draws, n: int, round_idx: int, batch: int,
                 class_params, ids=None):
    """Returns (signals (n, batch, WINDOW·CHANNELS) f32, labels (n, batch)
    int64)."""
    prior = client_label_prior(cfg, draws, n, round_idx, ids)
    gain = 1.0 + 0.2 * draws.client_normal("har.gain", (n, CHANNELS), ids=ids)
    phase_ofs = 0.5 * draws.client_normal("har.phase", (n, CHANNELS), ids=ids)
    labels = draws.categorical(
        "client_batch.labels", torch.log(prior + 1e-9), batch, round=round_idx,
        ids=ids,
    )
    freqs, amps, phases = class_params
    t = _time_axis(freqs.device)[:, None]  # (T, 1)
    f = freqs[labels][:, :, None, :]  # (n, B, 1, C)
    a = amps[labels][:, :, None, :]
    p = phases[labels][:, :, None, :] + phase_ofs[:, None, None, :]
    sig = a * torch.sin(f * t + p) * gain[:, None, None, :]
    noise = draws.normal(
        "client_batch.noise", (n, batch, WINDOW * CHANNELS), round=round_idx, ids=ids
    )
    sig = sig.reshape(n, batch, WINDOW * CHANNELS) + cfg.noise * noise
    return sig.to(torch.float32), labels


def client_histogram(cfg: HarLikeConfig, draws, n: int, round_idx, ids=None):
    """(n, K): the label prior itself (HAR's drift re-draws the prior and
    permutes no labels)."""
    return client_label_prior(cfg, draws, n, round_idx, ids)


def eval_batch(cfg: HarLikeConfig, draws, round_idx: int, batch: int, class_params,
               uses: int = 0):
    """IID test split (uniform labels, no client gain or phase offset):
    (signals (batch, WINDOW·CHANNELS), labels); ``uses`` keys a repeat
    flush's batch (``random.flush_context``)."""
    freqs, amps, phases = class_params
    ctx = flush_context(round_idx, uses)
    labels = draws.randint("eval.labels", (batch,), NUM_CLASSES, **ctx)
    t = _time_axis(freqs.device)[:, None]
    sig = amps[labels][:, None, :] * torch.sin(
        freqs[labels][:, None, :] * t + phases[labels][:, None, :]
    )
    noise = draws.normal("eval.noise", (batch, WINDOW * CHANNELS), **ctx)
    sig = sig.reshape(batch, WINDOW * CHANNELS) + cfg.noise * noise
    return sig.to(torch.float32), labels
