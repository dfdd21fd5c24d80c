"""Test draw provider: hands the port the JAX package's own random draws.

``repro_torch`` takes every random draw from a provider by call-site name
(see ``repro_torch/random.py``). This provider recomputes each block with
``jax.random`` along the key chain the JAX package uses, so the port and
the JAX package can be held against each other on identical data:

  * state init: ``PRNGKey(seed)`` (MLP, split per layer), ``seed + 10``
    (templates), ``+ 11`` / ``+ 12`` / ``+ 13`` (drift flags, Dirichlet
    priors, drift permutation), ``+ 30`` / ``+ 31`` (profiles, telemetry),
    ``+ 40`` / ``+ 41`` (data sizes, attacker placement);
  * HAR: ``seed + 20`` (class signals, split 3), ``+ 21`` / ``+ 22``
    (drift flags, Dirichlet priors), ``+ 23`` folded with the client id
    (its channel gain; folded again with 1: its phase offset);
  * per round: ``PRNGKey(seed + 100)`` split once per round, then the
    6-way split ``(sel, data, attack, dp, tel, eval)`` and the population
    cohort's ``fold_in(k, 7)``; the client at cohort position ``i`` with
    id ``c`` draws its batch from ``split(k_data, n)[i]`` →
    ``split(fold_in(., c))``. The attacks' normals split ``attack`` once
    per leaf;
  * faults: ``fold_in(k, 8)`` split into ``(plan, noise)``; ``plan`` split
    5 ways into ``(attempts, partition, partition_frac, fog, corrupt)``;
    attempt ``a`` of ``A`` takes ``split(attempts, A)[a]``, split 3 ways
    into ``(timeout, crash, drop)``; ``noise`` is split once per leaf;
  * the async engine (``repro/sim/events/engine.py``): dispatch ``d`` takes
    round ``d``'s key ``k`` and its 6-way split, plus ``fold_in(k, 101)``
    (``churn``), ``102`` (``straggler``), ``103`` (``cohort.async``) and
    ``104`` (``async.faults.*``, split 7 ways into ``(attempt0, partition,
    partition_frac, corrupt, noise, fog, client)``; attempt 0 splits 3 ways
    into ``(timeout, crash, drop)``; the retry of client ``c``'s attempt
    ``a`` takes ``split(fold_in(fold_in(client, c), a))`` as ``(retry,
    retry_noise)``); ``churn.init`` is ``fold_in(PRNGKey(seed + 100),
    2718)``. A flush consumes its dispatch's ``dp`` / ``tel`` / ``eval``
    keys as they are when ``uses`` is 0 and ``fold_in(key, uses)`` after.

The LM round and its synthetic data (``repro/fl/round.py``,
``repro/data/synthetic.py``), when the provider is given the FL state's
initial key ``fl_rng``:

  * round ``r`` (the state's step) takes the key ``rng_r`` of the state
    after ``r`` rounds (each round splits 5 ways into ``(rng, sched,
    attack, dp, mal)``): ``rcs.perm`` from ``sched``, ``attack`` (one key
    per leaf), ``dp``, ``slots.malicious`` from ``mal``, ``cohort`` from
    ``fold_in(rng_r, 7)`` and ``faults.*`` from ``fold_in(rng_r, 11)``,
    split as the simulator's ``fold_in(k, 8)``;
  * ``lm.domains`` is ``PRNGKey(seed)``, ``lm.drift.flags`` ``seed + 1``
    folded with the epoch and then the client, ``lm.mixture`` ``seed + 2``
    folded with the client and then the epoch, ``lm.data_sizes``
    ``seed + 3``; a round's tokens come from ``launch/train.py``'s chain
    ``PRNGKey(seed + 1)`` split twice a round (batch key, telemetry key):
    slot ``i`` with client ``c`` takes ``split(fold_in(split(kb, C)[i],
    c))`` as ``(lm.tokens, lm.copy)``.

A serving trace (``repro/serve/arrivals.py``) splits ``PRNGKey(seed)``
4 ways: ``serve.arrival``, ``serve.gen_len``, ``serve.prompts`` and
``serve.patches`` (a VLM trace's patch embeddings) take the four keys (``jax.random.randint`` from ``lo`` equals ``lo``
plus its draw from 0 over the same span, so ``gen_len``'s offset draw is
the JAX package's).

Every per-client draw takes ``ids``, the client ids of the rows, which
default to ``arange(n)`` (the dense registry); the prior and the drift
flags and permutation also take per-client epochs.

Blocks come back as CPU torch tensors.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

_ROUND_KEYS = ("sel", "data", "attack", "dp", "tel", "eval")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _ids(ids, n):
    if ids is None:
        return jnp.arange(n, dtype=jnp.int32)
    return jnp.asarray(np.asarray(ids), jnp.int32)


def _per_client(x, n):
    """An int or a tensor of per-client values -> an (n,) int32 array."""
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return jnp.broadcast_to(jnp.asarray(x, jnp.int32), (n,))


@functools.partial(jax.jit, static_argnames=("n_draw",))
def _client_labels(k_data, logits, n_draw, cids):
    n = logits.shape[0]

    def one(key, cid, lg):
        k1, _ = jax.random.split(jax.random.fold_in(key, cid))
        return jax.random.categorical(k1, lg, shape=(n_draw,))

    return jax.vmap(one)(jax.random.split(k_data, n), cids, logits)


@functools.partial(jax.jit, static_argnames=("shape",))
def _client_copy(k_data, shape, cids):
    def one(key, cid):
        _, k2 = jax.random.split(jax.random.fold_in(key, cid))
        return jax.random.uniform(k2, shape)

    return jax.vmap(one)(jax.random.split(k_data, cids.shape[0]), cids)


@functools.partial(jax.jit, static_argnames=("n_draw", "dim"))
def _client_noise(k_data, n_draw, dim, cids):
    # threefry draws a flat block: (n_draw, dim) holds the same values as
    # the package's (n_draw, 28, 28) or (n_draw, 128, 9), reshaped.
    def one(key, cid):
        _, k2 = jax.random.split(jax.random.fold_in(key, cid))
        return jax.random.normal(k2, (n_draw, dim))

    return jax.vmap(one)(jax.random.split(k_data, cids.shape[0]), cids)


@functools.partial(jax.jit, static_argnames=("k", "offset"))
def _priors(seed, cids, epochs, alpha, k, offset):
    def one(c, e):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(seed + offset), c), e
        )
        return jax.random.dirichlet(key, jnp.full((k,), alpha))

    return jax.vmap(one)(cids, epochs)


_FAULT_PLAN = ("attempts", "partition", "partition_frac", "fog", "corrupt")
_ATTEMPT_SITES = {"faults.timeout": 0, "faults.crash": 1, "faults.drop": 2}
_SERVE = {"serve.arrival": 0, "serve.gen_len": 1, "serve.prompts": 2, "serve.patches": 3}
_ASYNC_FOLDS = {"churn": 101, "straggler": 102, "cohort.async": 103}
_ASYNC_FAULTS = ("attempt0", "partition", "partition_frac", "corrupt", "noise",
                 "fog", "client")
_ASYNC_ATTEMPT0 = {"async.faults.timeout": 0, "async.faults.crash": 1,
                   "async.faults.drop": 2}


def _fresh(key, uses):
    """A flush's key: the dispatch's own at ``uses`` 0, folded after."""
    return key if not uses else jax.random.fold_in(key, uses)


class JaxDraws:
    """Draw provider replaying ``jax.random`` along the JAX package's keys."""

    def __init__(self, seed: int, fl_rng=None):
        self.seed = int(seed)
        self.device = torch.device("cpu")
        self.fl_rng = None if fl_rng is None else jnp.asarray(np.asarray(fl_rng),
                                                              jnp.uint32)
        self._rounds: dict[int, dict] = {}

    def _fl_round_keys(self, r: int) -> dict:
        rng = self.fl_rng
        for _ in range(r):
            rng = jax.random.split(rng, 5)[0]
        _, k_sched, k_attack, k_dp, k_mal = jax.random.split(rng, 5)
        keys = {"sel": k_sched, "attack": k_attack, "dp": k_dp,
                "slots.malicious": k_mal, "cohort": jax.random.fold_in(rng, 7)}
        k_plan, keys["faults.noise"] = jax.random.split(jax.random.fold_in(rng, 11))
        keys.update(zip((f"faults.{x}" for x in _FAULT_PLAN),
                        jax.random.split(k_plan, 5)))
        return keys

    def _lm_batch_key(self, r: int):
        """``launch/train.py``'s batch key of round ``r``."""
        key = jax.random.PRNGKey(self.seed + 1)
        for _ in range(r):
            key = jax.random.split(jax.random.split(key)[0])[0]
        return jax.random.split(key)[1]

    def round_key(self, r: int, name: str):
        if r not in self._rounds and self.fl_rng is not None:
            self._rounds[r] = self._fl_round_keys(r)
        if r not in self._rounds:
            key = jax.random.PRNGKey(self.seed + 100)
            for _ in range(r + 1):
                key, k = jax.random.split(key)
            self._rounds[r] = dict(zip(_ROUND_KEYS, jax.random.split(k, 6)))
            self._rounds[r]["cohort"] = jax.random.fold_in(k, 7)
            k_plan, k_noise = jax.random.split(jax.random.fold_in(k, 8))
            self._rounds[r]["faults.noise"] = k_noise
            self._rounds[r].update(zip(
                (f"faults.{x}" for x in _FAULT_PLAN), jax.random.split(k_plan, 5)))
            for site, fold in _ASYNC_FOLDS.items():
                self._rounds[r][site] = jax.random.fold_in(k, fold)
            self._rounds[r].update(zip(
                (f"async.faults.{x}" for x in _ASYNC_FAULTS),
                jax.random.split(jax.random.fold_in(k, 104), 7)))
        return self._rounds[r][name]

    def _retry_keys(self, round, client, attempt):
        """(outcome, noise) keys of attempt ``attempt`` of the retry chain
        of ``client``, admitted at dispatch ``round``."""
        k = jax.random.fold_in(self.round_key(round, "async.faults.client"), client)
        return jax.random.split(jax.random.fold_in(k, attempt))

    def _leafwise(self, key, shape, segments):
        """(C, P) normals, one key of ``split(key, len(segments))`` per
        leaf, each leaf's (C, size) block side by side."""
        keys = jax.random.split(key, len(segments))
        c = shape[0]
        return _t(jnp.concatenate(
            [jax.random.normal(k, (c, s)) for k, s in zip(keys, segments)], axis=1))

    def _serve_key(self, site):
        """``serve.arrivals.make_trace``'s split of ``PRNGKey(seed)``."""
        return jax.random.split(jax.random.PRNGKey(self.seed), 4)[_SERVE[site]]

    def _init_key(self, offset: int, index: int | None = None, parts: int = 0):
        key = jax.random.PRNGKey(self.seed + offset)
        return key if index is None else jax.random.split(key, parts)[index]

    # ------------------------------------------------------------------ #
    def normal(self, site, shape, *, segments=None, round=None, index=None,
               epoch=None, ids=None, uses=0, attempt=None):
        shape = tuple(shape)
        if site == "init.mlp":
            key = jax.random.PRNGKey(self.seed)
            for _ in range(index + 1):
                k1, key = jax.random.split(key)
            return _t(jax.random.normal(k1, shape))
        if site in _SERVE:
            return _t(jax.random.normal(self._serve_key(site), shape))
        offsets = {"templates": 10, "data_sizes": 40, "lm.domains": 0,
                   "lm.data_sizes": 3}
        if site in offsets:
            return _t(jax.random.normal(self._init_key(offsets[site]), shape))
        profiles = {"profiles.mips": 1, "profiles.bw_up": 2, "profiles.rtt": 3}
        if site in profiles:
            return _t(jax.random.normal(self._init_key(30, profiles[site], 5), shape))
        if site == "client_batch.noise":
            n, n_draw, dim = shape
            return _t(_client_noise(self.round_key(round, "data"), n_draw, dim,
                                    _ids(ids, n)))
        if site == "eval.noise":
            _, k2 = jax.random.split(_fresh(self.round_key(round, "eval"), uses))
            return _t(jax.random.normal(k2, shape))
        if site in ("straggler", "async.faults.noise"):
            return _t(jax.random.normal(self.round_key(round, site), shape))
        if site == "async.faults.retry_noise":
            return _t(jax.random.normal(self._retry_keys(round, index, attempt)[1],
                                        shape))
        if site in ("attack", "faults.noise"):
            return self._leafwise(self.round_key(round, site), shape, segments)
        if site == "telemetry.ar":
            k1, k2 = jax.random.split(_fresh(self.round_key(round, "tel"), uses))
            n = shape[1]
            return _t(jnp.stack([jax.random.normal(k1, (n,)),
                                 jax.random.normal(k2, (n,))]))
        if site == "dp":
            keys = jax.random.split(_fresh(self.round_key(round, "dp"), uses),
                                    len(segments))
            return _t(jnp.concatenate(
                [jax.random.normal(k, (s,)) for k, s in zip(keys, segments)]
            ))
        raise KeyError(site)

    def uniform(self, site, shape, lo, hi, *, round=None, index=None,
                attempts=None, attempt=None, ids=None):
        if site in _SERVE:
            return _t(jax.random.uniform(self._serve_key(site), tuple(shape), minval=lo,
                                         maxval=hi))
        if site == "lm.copy":
            return _t(_client_copy(self._lm_batch_key(round), tuple(shape[1:]),
                                   _ids(ids, shape[0])) * (hi - lo) + lo)
        if site == "churn.init":
            key = jax.random.fold_in(jax.random.PRNGKey(self.seed + 100), 2718)
        elif site == "churn":
            key = self.round_key(round, site)
        elif site in _ASYNC_ATTEMPT0:
            key = jax.random.split(self.round_key(round, "async.faults.attempt0"),
                                   3)[_ASYNC_ATTEMPT0[site]]
        elif site == "async.faults.retry":
            key = self._retry_keys(round, index, attempt)[0]
        elif site.startswith("async.faults."):
            key = self.round_key(round, site)
        elif site in _ATTEMPT_SITES:
            key = jax.random.split(self.round_key(round, "faults.attempts"),
                                   attempts)[index]
            key = jax.random.split(key, 3)[_ATTEMPT_SITES[site]]
        elif site.startswith("faults."):
            key = self.round_key(round, site)
        elif site.startswith("har."):
            part = {"har.freqs": 0, "har.amps": 1, "har.phases": 2}[site]
            key = self._init_key(20, part, 3)
        else:
            part = {"telemetry.init.cpu": 0, "telemetry.init.mem": 1,
                    "telemetry.init.batt": 2}[site]
            key = self._init_key(31, part, 4)
        return _t(jax.random.uniform(key, tuple(shape), minval=lo, maxval=hi))

    def client_normal(self, site, shape, *, ids=None):
        n, k = shape
        base = jax.random.PRNGKey(self.seed + 23)
        keys = jax.vmap(lambda c: jax.random.fold_in(base, c))(_ids(ids, n))
        if site == "har.phase":
            keys = jax.vmap(lambda x: jax.random.fold_in(x, 1))(keys)
        else:
            assert site == "har.gain", site
        return _t(jax.vmap(lambda x: jax.random.normal(x, (k,)))(keys))

    def randint(self, site, shape, high, *, round=None, uses=0):
        if site in _SERVE:
            key = self._serve_key(site)
        elif site == "profiles.class":
            key = self._init_key(30, 0, 5)
        elif site == "eval.labels":
            key, _ = jax.random.split(_fresh(self.round_key(round, "eval"), uses))
        elif site in ("cohort", "cohort.async"):
            hi = jnp.asarray(np.asarray(high), jnp.int32)
            return _t(jax.random.randint(
                self.round_key(round, site), tuple(shape), jnp.zeros_like(hi), hi
            )).to(torch.int64)
        else:
            raise KeyError(site)
        return _t(jax.random.randint(key, tuple(shape), 0, high)).to(torch.int64)

    def permutation(self, site, n, *, round=None, epoch=None):
        if site == "malicious":
            key = self._init_key(41)
        elif site == "drift.perm" and isinstance(epoch, torch.Tensor):
            e = _per_client(epoch, epoch.shape[0])
            base = jax.random.PRNGKey(self.seed + 13)
            return _t(jax.vmap(
                lambda x: jax.random.permutation(jax.random.fold_in(base, x), n)
            )(e)).to(torch.int64)
        elif site == "drift.perm":
            key = jax.random.fold_in(jax.random.PRNGKey(self.seed + 13), epoch)
        elif site == "rcs.perm":
            key = self.round_key(round, "sel")
        elif site == "slots.malicious":
            key = self.round_key(round, site)
        else:
            raise KeyError(site)
        return _t(jax.random.permutation(key, n)).to(torch.int64)

    def bernoulli(self, site, p, shape, *, epoch, ids=None):
        n = shape[0]
        base = jax.random.PRNGKey(self.seed + {"drift.flags": 11, "har.drift.flags": 21,
                                               "lm.drift.flags": 1}[site])
        flags = jax.vmap(
            lambda c, e: jax.random.bernoulli(
                jax.random.fold_in(jax.random.fold_in(base, e), c), p)
        )(_ids(ids, n), _per_client(epoch, n))
        return _t(flags)

    def dirichlet(self, site, alpha, shape, *, epoch, ids=None):
        n, k = shape
        offset = {"prior": 12, "har.prior": 22, "lm.mixture": 2}[site]
        return _t(_priors(self.seed, _ids(ids, n), _per_client(epoch, n), alpha, k,
                          offset))

    def categorical(self, site, logits, n, *, round, ids=None):
        lg = jnp.asarray(logits.detach().cpu().numpy())
        cids = _ids(ids, lg.shape[0])
        if site == "lm.tokens":
            key = self._lm_batch_key(round)
        else:
            assert site == "client_batch.labels", site
            key = self.round_key(round, "data")
        return _t(_client_labels(key, lg, n, cids)).to(torch.int64)
