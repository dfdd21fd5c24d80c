"""Deterministic synthetic federated token data (port of
``repro/data/synthetic.py``).

Non-IID structure by the Dirichlet-partition protocol: each logical
client owns a mixture over K latent *domains*, each domain a unigram
token distribution. Data drift re-draws a fraction of the clients'
mixtures every ``drift_period`` rounds, which moves their token
histograms and so their Eq. 2 KL score, the signal FedFog's scheduler
gates on.

Every draw comes from the draw provider (``repro_torch.random``):
``lm.domains`` (the (K, V) domain logits), ``lm.drift.flags`` and
``lm.mixture`` (per client and drift epoch, counter-based, so a client's
mixture is the same in every round of an epoch), ``lm.tokens`` and
``lm.copy`` (a round's batch, keyed by the round and the slot
occupants' ids) and ``lm.data_sizes``. The provider's seed keys the data;
``FedDataConfig.seed`` is kept for the configuration's sake, as the
simulator's data configs keep theirs. Functions take the client ids as a
(C,) tensor and batch over them (the JAX package vmaps one client).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import scalar

Array = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FedDataConfig:
    vocab_size: int = 256
    num_domains: int = 8
    dirichlet_alpha: float = 0.5  # lower = more non-IID
    drift_period: int = 0  # re-draw mixtures every k rounds (0 = never)
    drift_fraction: float = 0.3  # fraction of clients that drift
    seed: int = 0


def _domain_logits(cfg: FedDataConfig, draws) -> Array:
    """(K, V) unigram logits per latent domain."""
    return draws.normal("lm.domains", (cfg.num_domains, cfg.vocab_size)) * 2.0


def client_mixture(cfg: FedDataConfig, draws, client_ids: Array, round_idx: int) -> Array:
    """(C, K) Dirichlet mixtures of ``client_ids``, re-drawn on the drift
    epochs of the clients that drift."""
    n = client_ids.shape[0]
    if cfg.drift_period:
        epoch = int(round_idx) // cfg.drift_period
        drifts = draws.bernoulli("lm.drift.flags", cfg.drift_fraction, (n,),
                                 epoch=epoch, ids=client_ids)
        eff_epoch = drifts.to(torch.int64) * epoch
    else:
        eff_epoch = 0
    return draws.dirichlet("lm.mixture", cfg.dirichlet_alpha, (n, cfg.num_domains),
                           epoch=eff_epoch, ids=client_ids)


def client_token_logits(cfg: FedDataConfig, draws, client_ids: Array,
                        round_idx: int) -> Array:
    """(C, V) unigram logits of ``client_ids`` at one round."""
    mix = client_mixture(cfg, draws, client_ids, round_idx)
    probs = torch.softmax(_domain_logits(cfg, draws), dim=-1)  # (K, V)
    return torch.log(mix @ probs + 1e-9)


def client_tokens(cfg: FedDataConfig, draws, client_ids: Array, round_idx: int,
                  batch: int, seq_len: int) -> Array:
    """(C, batch, seq_len+1) int32 token sequences of each client's round
    batch: unigram draws from its logits, then with probability 0.5 each
    token replaced by the token two positions back (first-order structure,
    so language-model training has signal)."""
    n = client_ids.shape[0]
    logits = client_token_logits(cfg, draws, client_ids, round_idx)
    shape = (n, batch, seq_len + 1)
    toks = draws.categorical("lm.tokens", logits, batch * (seq_len + 1),
                             round=round_idx, ids=client_ids).reshape(shape)
    copy = draws.uniform("lm.copy", shape, 0.0, 1.0, round=round_idx,
                         ids=client_ids) < 0.5
    toks = torch.where(copy, torch.roll(toks, 2, dims=2), toks)
    return toks.to(torch.int32)


def client_histogram(cfg: FedDataConfig, draws, client_ids: Array, round_idx: int,
                     bins: int) -> Array:
    """(C, bins) expected token histograms, the scheduler's Eq. 2 input:
    the exact mixture distribution (not a sample), folded into bins."""
    probs = torch.exp(client_token_logits(cfg, draws, client_ids, round_idx))
    pad = (-cfg.vocab_size) % bins
    if pad:
        probs = torch.cat([probs, torch.zeros((probs.shape[0], pad),
                                              dtype=probs.dtype, device=probs.device)], 1)
    return probs.reshape(probs.shape[0], bins, -1).sum(-1)


def all_client_histograms(cfg: FedDataConfig, draws, num_clients: int,
                          round_idx: int, bins: int) -> Array:
    ids = torch.arange(num_clients, dtype=torch.int64, device=draws.device)
    return client_histogram(cfg, draws, ids, round_idx, bins)


def round_batch(cfg: FedDataConfig, draws, slot_client_ids: Array, round_idx: int,
                per_slot_batch: int, seq_len: int) -> Array:
    """(num_slots × per_slot_batch, seq_len+1), the slot-major global batch."""
    toks = client_tokens(cfg, draws, slot_client_ids, round_idx, per_slot_batch, seq_len)
    return toks.reshape(-1, seq_len + 1)


def client_data_sizes(cfg: FedDataConfig, draws, num_clients: int) -> Array:
    """(N,) static per-client dataset sizes |D_i| (log-normal)."""
    z = draws.normal("lm.data_sizes", (num_clients,))
    return torch.exp(z * 0.5 + torch.log(scalar(300.0, z.device)))
