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
  ``prior``                     (C, K) Dirichlet label priors of client
                                ``ids`` at (per-client) ``epoch``
  ``drift.flags``               (C,) Bernoulli drift flags of ``ids``
  ``drift.perm``                (K,) label permutation at ``epoch``, or
                                (C, K) for a (C,) tensor of epochs
  ``cohort``                    (C,) offsets below per-stratum widths
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
  ``attack``                    (C, P) normals of the noise and
                                model-replacement attacks, leaf by leaf
  ``har.freqs|amps|phases``     (6, 9) uniforms of the HAR class signals
  ``har.prior``                 (C, 6) HAR label priors of ``ids`` at
                                (per-client) ``epoch``
  ``har.drift.flags``           (C,) HAR drift flags of ``ids``
  ``har.gain`` / ``har.phase``  (C, 9) normals of the per-client channel
                                gain and phase offset of ``ids``
  ``faults.partition``          () uniform: the round's partition gate
  ``faults.partition_frac``     (C,) uniforms: who the partition cuts off
  ``faults.timeout|crash|drop`` (C,) uniforms of attempt ``index`` of
                                ``attempts``
  ``faults.fog``                (F,) uniforms of the fog outages
  ``faults.corrupt``            (C,) uniforms of the corrupted payloads
  ``faults.noise``              (C, P) normals of the corruption, leaf by
                                leaf
  ``churn.init``                (C,) uniforms of the initial presence
  ``churn``                     (C,) uniforms of dispatch ``round``'s
                                arrivals and departures
  ``straggler``                 (C,) normals of dispatch ``round``'s
                                lognormal latency tail
  ``cohort.async``              (C,) offsets of dispatch ``round``'s
                                candidate cohort (population mode)
  ``async.faults.timeout|crash|drop``  (C,) uniforms of dispatch
                                ``round``'s first attempts
  ``async.faults.partition``    () and (C,) uniforms of dispatch ``round``'s
  ``|partition_frac``           partition
  ``async.faults.corrupt``      (C,) uniforms of the corrupted payloads
  ``async.faults.noise``        (C, P) normals of the corruption, one block
  ``async.faults.fog``          (F,) uniforms of the fog outages
  ``async.faults.retry``        (3,) uniforms (crash, drop, corrupt) of
                                attempt ``attempt`` of client ``index``'s
                                retry chain, admitted at dispatch ``round``
  ``async.faults.retry_noise``  (P,) normals of that attempt's corruption
  ``slots.malicious``           (C,) permutation placing the attackers among
                                the LM round's slots
  ``lm.domains``                (K, V) normals of the latent domains'
                                unigram logits
  ``lm.drift.flags``            (C,) Bernoulli drift flags of ``ids``
  ``lm.mixture``                (C, K) Dirichlet domain mixtures of ``ids``
                                at (per-client) ``epoch``
  ``lm.tokens``                 (C, B·(S+1)) tokens of a round's slots
                                ``ids``, row c from ``softmax(logits[c])``
  ``lm.copy``                   (C, B, S+1) uniforms of the copy mask
  ``lm.data_sizes``             (C,) normals of the log dataset sizes
  ============================  ==========================================

The LM round (``fl.round``) keys its draws (``rcs.perm``,
``slots.malicious``, ``attack``, ``dp``, ``cohort``, ``faults.*``) by the
round index ``state.step``, a host integer; the synthetic token data
(``data.synthetic``) keys ``lm.tokens`` / ``lm.copy`` by the round and
the slot occupants' ids.

The async engine (``sim.events.engine``) keys its dispatch draws by the
dispatch index as ``round``, exactly as ``_round`` keys a round's, so a
dispatch makes the draws of the round of the same index. A flush draws
``dp``, ``telemetry.ar`` and ``eval.*`` with the context of
:func:`flush_context`: the first flush after dispatch ``d`` takes round
``d``'s draws as they are (cohort mode reproduces the synchronous round),
a repeat flush before the next dispatch adds its use count ``uses``.

Production (:class:`TorchDraws`) seeds a fresh ``torch.Generator`` on the
simulator's device from a hash of ``(seed, site, context)``: every block
is a pure function of its key, so ``run()`` and ``run_scanned()`` replay
each other.

Some sites are keyed per CLIENT rather than per block: ``prior``,
``drift.flags`` (both by client id and drift epoch), ``drift.perm`` (by
epoch) and their HAR counterparts ``har.prior``, ``har.drift.flags``,
``har.gain`` and ``har.phase`` (by client id). A client's label prior must be the same in every round of
an epoch and in whichever cohort it lands (the Eq. 2 drift gate compares
it with itself), and in population mode the cohort is 64 ids out of a
million. A dense (M, K) block per epoch would cost 62 M gamma draws, so
these sites use a counter-based generator written in torch integer ops:
``lowbias32`` (a full-avalanche bijection of 32-bit words) hashes
``(seed, site, id, epoch)`` into a per-client key, and a second pair of
hashes of ``(key, j)`` gives the client's j-th 32-bit word. The cost is
cohort-sized, the same on the CPU and the card, and needs no host
synchronisation even when each client has its own epoch (the population
drift reference, recomputed at each member's last-observed round).

Client ids enter the other per-client sites of a cohort
(``client_batch.*``) as ``ids``; the production provider keys those by
round and cohort position and ignores ``ids``, the test provider folds
them in as the JAX package does. The test provider, which replays the
JAX package's key chain, lives with the tests and is never imported here.
"""
from __future__ import annotations

import hashlib
import math

import torch


_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_GAMMA_TRIES = 16


# --------------------------------------------------------------------- #
# The JAX package's key format, on the host
# --------------------------------------------------------------------- #
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the uint32 counter pairs (x0, x1) under
    ``key``, as ``jax.random``'s threefry implementation computes it."""
    import numpy as np

    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(key[0]), np.uint32(key[1])
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x0 = (np.asarray(x0, np.uint32) + ks[0]).astype(np.uint32)
        x1 = (np.asarray(x1, np.uint32) + ks[1]).astype(np.uint32)
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = (x0 + x1).astype(np.uint32)
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]).astype(np.uint32)
            x1 = (x1 + ks[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
    return x0, x1


def prng_key(seed: int):
    """(2,) uint32 key words of ``jax.random.PRNGKey(seed)`` (32-bit seeds,
    as the JAX package runs without 64-bit mode: the low word is the seed
    modulo 2³², the high word 0)."""
    import numpy as np

    return np.array([0, int(seed) & _M32], dtype=np.uint32)


def split_key(key, num: int = 2):
    """(num, 2) uint32: ``jax.random.split(key, num)`` of a (2,) key, on the
    host (the JAX package's default, partitionable threefry: counter i's
    two output words are key i)."""
    import numpy as np

    hi, lo = _threefry2x32(key, np.zeros(num, np.uint32),
                           np.arange(num, dtype=np.uint32))
    return np.stack([hi, lo], axis=1)


def flush_context(round: int, uses: int) -> dict:
    """The context of a draw made at a flush: dispatch ``round``'s own for
    its first flush (``uses`` 0), with ``uses`` added for a repeat one."""
    return {"round": round, "uses": uses} if uses else {"round": round}


def _key(*parts) -> int:
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x·c mod 2³²`` for int64 ``x`` in [0, 2³²), in two 16-bit halves
    of ``c`` so that no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32: a bijection of 32-bit words with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class TorchDraws:
    """Production draw provider: keyed ``torch.Generator`` blocks on device,
    and counter-based per-client words for the sites keyed by client."""

    def __init__(self, seed: int, device: str | torch.device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._cache: dict[tuple, torch.Tensor] = {}

    def _gen(self, site: str, **ctx) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(_key(self.seed, site, sorted(ctx.items())))
        return g

    def _words(self, site: str, keys, epoch, count: int) -> torch.Tensor:
        """(n, count) int64 32-bit words: row i is a pure function of
        (seed, site, ``keys[i]``, ``epoch[i]``); ``epoch`` an int or (n,)."""
        keys = torch.as_tensor(keys, dtype=torch.int64, device=self.device)
        if isinstance(epoch, torch.Tensor):
            epoch = epoch.to(torch.int64)
        base = _mix32(_mix32(keys ^ (_key(self.seed, site) & _M32)) ^ epoch)[:, None]
        j = torch.arange(count, dtype=torch.int64, device=self.device)
        return _mix32(_mix32((base + _mul32(j, _GOLDEN)) & _M32) ^ base)

    def _counter_uniform(self, site, keys, epoch, count) -> torch.Tensor:
        """(n, count) float32 uniforms in (0, 1) from the top 24 bits."""
        w = self._words(site, keys, epoch, count)
        return ((w >> 8).to(torch.float32) + 0.5) * 2.0**-24

    def _ids(self, ids, n: int) -> torch.Tensor:
        return torch.arange(n, device=self.device) if ids is None else ids

    def normal(self, site: str, shape, *, segments=None, ids=None, **ctx):
        """Standard normals. ``segments`` (leaf sizes of a fused vector)
        only matters to a provider that draws leaf by leaf; ``ids`` (the
        cohort's client ids) to one that keys batches by client."""
        del segments, ids
        return torch.randn(
            tuple(shape), generator=self._gen(site, **ctx), device=self.device
        )

    def uniform(self, site: str, shape, lo: float, hi: float, *, ids=None, **ctx):
        """Uniforms in [lo, hi); ``ids`` (the slot occupants' ids of
        ``lm.copy``) only matters to a provider that keys by client."""
        del ids
        u = torch.rand(
            tuple(shape), generator=self._gen(site, **ctx), device=self.device
        )
        return torch.clamp(u * (hi - lo) + lo, min=lo)

    def randint(self, site: str, shape, high, **ctx) -> torch.Tensor:
        """Integers in [0, high); ``high`` an int or a tensor of per-element
        bounds (the ``cohort`` strata widths), then ``floor(u·high)``."""
        g = self._gen(site, **ctx)
        if isinstance(high, torch.Tensor):
            u = torch.rand(
                tuple(shape), generator=g, dtype=torch.float64, device=self.device
            )
            return torch.minimum(torch.floor(u * high).to(torch.int64), high - 1)
        return torch.randint(0, high, tuple(shape), generator=g, device=self.device)

    def permutation(self, site: str, n: int, *, epoch=None, **ctx) -> torch.Tensor:
        """A permutation of ``range(n)``. Keyed by ``epoch`` (``drift.perm``)
        it is counter-based: an argsort of ``n`` words per epoch, (n,) for
        an int epoch and (C, n) for a (C,) tensor of epochs."""
        if epoch is None:
            return torch.randperm(
                n, generator=self._gen(site, **ctx), device=self.device
            )
        e = torch.as_tensor(epoch, dtype=torch.int64, device=self.device)
        perm = torch.argsort(self._words(site, e.reshape(-1), 0, n), dim=1, stable=True)
        return perm.reshape(tuple(e.shape) + (n,))

    def client_normal(self, site: str, shape, *, ids=None) -> torch.Tensor:
        """(C, k) standard normals of clients ``ids`` (default
        ``arange(C)``), counter-based: row c depends only on (seed, site,
        ``ids[c]``). Box-Muller from the client's words."""
        n, k = shape
        u = self._counter_uniform(site, self._ids(ids, n), 0, 2 * k)
        return torch.sqrt(-2.0 * torch.log(u[:, :k])) * torch.cos(
            (2.0 * math.pi) * u[:, k:])

    def bernoulli(self, site: str, p: float, shape, *, epoch, ids=None):
        """(C,) flags of clients ``ids`` (default ``arange(C)``) at ``epoch``
        (an int or a (C,) tensor), counter-based."""
        ids = self._ids(ids, shape[0])
        return self._counter_uniform(site, ids, epoch, 1)[:, 0] < p

    def categorical(self, site: str, logits: torch.Tensor, n: int, *, ids=None, **ctx):
        """(C, n) int64 samples, row c from ``softmax(logits[c])``."""
        del ids
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(
            probs, n, replacement=True, generator=self._gen(site, **ctx)
        )

    def dirichlet(self, site: str, alpha: float, shape, *, epoch, ids=None):
        """(C, K) Dirichlet(alpha) rows of clients ``ids`` (default
        ``arange(C)``) at ``epoch`` (an int or a (C,) tensor), counter-based.
        The dense block (no ``ids``, an int epoch) is cached."""
        key = None
        if ids is None and isinstance(epoch, int):
            key = (site, tuple(shape), float(alpha), epoch)
            if key in self._cache:
                return self._cache[key]
        n, k = shape
        t = _GAMMA_TRIES
        u = self._counter_uniform(site, self._ids(ids, n), epoch, 3 * t * k + k)
        u1, u2, ua = (u[:, i * t * k:(i + 1) * t * k].reshape(n, t, k) for i in range(3))
        # Box-Muller normals for the Marsaglia-Tsang candidates.
        x = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
        out = torch.softmax(_log_gamma(float(alpha), x, ua, u[:, 3 * t * k:]), dim=-1)
        if key is not None:
            self._cache[key] = out
        return out


def _log_gamma(alpha, x, u, u_boost):
    """log Gamma(alpha, 1) by Marsaglia–Tsang from (n, tries, K) standard
    normals ``x`` and uniforms ``u``, without host syncs.

    The first accepted of the ``tries`` candidates is taken (acceptance is
    ≥ 0.95 per try for a ≥ 1, so 16 tries fail with probability < 1e-20).
    alpha < 1 uses the boost Gamma(a) = Gamma(a + 1) · U^(1/a) with the
    (n, K) uniforms ``u_boost``, kept in log space so that tiny values do
    not underflow before the Dirichlet normalisation.
    """
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    v = torch.clamp((1.0 + c * x) ** 3, min=1e-30)
    ok = (1.0 + c * x > 0) & (
        torch.log(torch.clamp(u, min=1e-38))
        < 0.5 * x * x + d - d * v + d * torch.log(v)
    )
    first = ok.to(torch.int8).argmax(dim=1, keepdim=True)
    log_g = math.log(d) + torch.log(v.gather(1, first).squeeze(1))
    if alpha < 1.0:
        log_g = log_g + torch.log(torch.clamp(u_boost, min=1e-38)) / alpha
    return log_g
