"""The draw provider: every random draw of the round path, by call site.

``jax.random`` and ``torch.Generator`` cannot produce the same numbers,
so the port never draws directly. Each function that draws takes a
provider and asks it for one block of variates by the NAME of its call
site plus the context that keys it (``round``, ``epoch``, ``index``):

  ============================  ==========================================
  site                          what is drawn
  ============================  ==========================================
  ``init.mlp``                  standard normals of layer ``index``'s w
  ``templates``                 (K, 7, 7) normals of the class templates
  ``prior``                     (C, K) Dirichlet label priors at ``epoch``
  ``drift.flags``               (C,) Bernoulli drift flags at ``epoch``
  ``drift.perm``                (K,) label permutation at ``epoch``
  ``profiles.class``            (C,) device class in {0, 1, 2}
  ``profiles.mips|bw_up|rtt``   (C,) normals of the device profiles
  ``telemetry.init.cpu|mem|batt``  (C,) uniforms of the initial telemetry
  ``data_sizes``                (C,) normals of the log data sizes
  ``malicious``                 (C,) permutation placing the attackers
  ``client_batch.labels``       (C, E·B) labels from the per-client priors
  ``client_batch.noise``        (C, E·B, 784) pixel noise normals
  ``eval.labels`` / ``eval.noise``  the held-out batch of one round
  ``telemetry.ar``              (2, C) AR(1) innovations (cpu, mem)
  ``dp``                        (P,) DP noise normals, leaf by leaf
  ``rcs.perm``                  (C,) permutation of the RCS baseline
  ============================  ==========================================

Production (:class:`TorchDraws`) seeds a fresh ``torch.Generator`` on the
simulator's device from a hash of ``(seed, site, context)``: every block
is a pure function of its key, so ``run()`` and ``run_scanned()`` replay
each other and the label prior of (client, drift epoch) is the same in
every round that asks for it (a stateful stream would hand each round a
new prior and the Eq. 2 drift gate would flag every client). The test
provider, which replays the JAX package's key chain, lives with the
tests and is never imported here.
"""
from __future__ import annotations

import hashlib
import math

import torch


def _key(*parts) -> int:
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


class TorchDraws:
    """Production draw provider: keyed ``torch.Generator`` blocks on device."""

    def __init__(self, seed: int, device: str | torch.device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._cache: dict[tuple, torch.Tensor] = {}

    def _gen(self, site: str, **ctx) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_key(self.seed, site, sorted(ctx.items())))
        return g

    def normal(self, site: str, shape, *, segments=None, **ctx) -> torch.Tensor:
        """Standard normals. ``segments`` (leaf sizes of a fused vector)
        only matters to a provider that draws leaf by leaf."""
        del segments
        return torch.randn(
            tuple(shape), generator=self._gen(site, **ctx), device=self.device
        )

    def uniform(self, site: str, shape, lo: float, hi: float, **ctx):
        u = torch.rand(
            tuple(shape), generator=self._gen(site, **ctx), device=self.device
        )
        return torch.clamp(u * (hi - lo) + lo, min=lo)

    def randint(self, site: str, shape, high: int, **ctx) -> torch.Tensor:
        return torch.randint(
            0, high, tuple(shape), generator=self._gen(site, **ctx),
            device=self.device,
        )

    def permutation(self, site: str, n: int, **ctx) -> torch.Tensor:
        return torch.randperm(
            n, generator=self._gen(site, **ctx), device=self.device
        )

    def bernoulli(self, site: str, p: float, shape, **ctx) -> torch.Tensor:
        u = torch.rand(
            tuple(shape), generator=self._gen(site, **ctx), device=self.device
        )
        return u < p

    def categorical(self, site: str, logits: torch.Tensor, n: int, **ctx):
        """(C, n) int64 samples, row c from ``softmax(logits[c])``."""
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(
            probs, n, replacement=True, generator=self._gen(site, **ctx)
        )

    def dirichlet(self, site: str, alpha: float, shape, **ctx) -> torch.Tensor:
        """(C, K) Dirichlet(alpha) rows, cached per (site, context)."""
        key = (site, tuple(shape), float(alpha), tuple(sorted(ctx.items())))
        hit = self._cache.get(key)
        if hit is None:
            log_g = _log_gamma_sample(
                float(alpha), tuple(shape), self._gen(site, **ctx), self.device
            )
            hit = self._cache[key] = torch.softmax(log_g, dim=-1)
        return hit


def _log_gamma_sample(alpha, shape, g, device, tries: int = 16):
    """log Gamma(alpha, 1) by Marsaglia–Tsang, without host syncs.

    A fixed number of candidates is drawn and the first accepted one is
    taken (acceptance is ≥ 0.95 per try for a ≥ 1, so 16 tries fail with
    probability < 1e-20). alpha < 1 uses the boost
    Gamma(a) = Gamma(a + 1) · U^(1/a), kept in log space so that tiny
    values do not underflow before the Dirichlet normalisation.
    """
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = torch.randn((tries,) + shape, generator=g, device=device)
    u = torch.rand((tries,) + shape, generator=g, device=device)
    v = torch.clamp((1.0 + c * x) ** 3, min=1e-30)
    ok = (1.0 + c * x > 0) & (
        torch.log(torch.clamp(u, min=1e-38))
        < 0.5 * x * x + d - d * v + d * torch.log(v)
    )
    first = ok.to(torch.int8).argmax(dim=0, keepdim=True)
    log_g = math.log(d) + torch.log(v.gather(0, first).squeeze(0))
    if alpha < 1.0:
        u2 = torch.rand(shape, generator=g, device=device)
        log_g = log_g + torch.log(torch.clamp(u2, min=1e-38)) / alpha
    return log_g
