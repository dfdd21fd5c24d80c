"""The port's synthetic federated token data (``repro_torch.data.
synthetic``) against the JAX package's, on the JAX package's draws
(``_jax_draws.JaxDraws`` replays ``repro/data/synthetic.py``'s key chain
and ``launch/train.py``'s batch keys), and the full-registry row
gather / scatter of ``fl.fog`` against the JAX functions.

Tokens equal exactly; histograms to ``atol=1e-7`` (probabilities from
exp(log(mix @ softmax))); dataset sizes (~300) to ``rtol=1e-6``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_draws import JaxDraws
from _threads import one_thread  # noqa: F401 (autouse)

from repro.core.types import init_scheduler_state as jax_init_sched
from repro.data import synthetic as js
from repro.fl import fog as jfog
from repro_torch.core.types import init_scheduler_state
from repro_torch.data import synthetic as ts
from repro_torch.fl import fog as tfog

SEED = 5


def _cfgs(**kw):
    return js.FedDataConfig(seed=SEED, **kw), ts.FedDataConfig(seed=SEED, **kw)


def _batch_key(r):
    """``launch/train.py``'s batch key of round ``r``."""
    key = jax.random.PRNGKey(SEED + 1)
    for _ in range(r):
        key, _ = jax.random.split(key)
        key, _ = jax.random.split(key)
    return jax.random.split(key)[1]


@pytest.mark.parametrize("drift", [0, 2], ids=["no-drift", "drift-2"])
def test_round_batch_tokens_equal_jax(drift):
    jc, tc = _cfgs(drift_period=drift)
    draws = JaxDraws(SEED)
    ids = np.array([3, 7, 1, 30], np.int32)
    for r in range(5):
        want = np.asarray(js.round_batch(jc, jnp.asarray(ids), jnp.asarray(r),
                                         _batch_key(r), 3, 16))
        got = ts.round_batch(tc, draws, torch.from_numpy(ids.astype(np.int64)), r, 3, 16)
        assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("drift", [0, 2], ids=["no-drift", "drift-2"])
def test_histograms_and_sizes_match_jax(drift):
    jc, tc = _cfgs(drift_period=drift, drift_fraction=0.5)
    draws = JaxDraws(SEED)
    for r in (0, 1, 2, 5):
        want = np.asarray(js.all_client_histograms(jc, 32, jnp.asarray(r), 64))
        got = ts.all_client_histograms(tc, draws, 32, r, 64).numpy()
        np.testing.assert_allclose(got, want, atol=1e-7)
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(ts.client_data_sizes(tc, draws, 32).numpy(),
                               np.asarray(js.client_data_sizes(jc, 32)), rtol=1e-6)


def test_drift_moves_some_histograms():
    """Drift re-draws the mixtures of some clients at each epoch, and only
    at epoch boundaries."""
    _, tc = _cfgs(drift_period=2, drift_fraction=0.5)
    draws = JaxDraws(SEED)
    h = [ts.all_client_histograms(tc, draws, 32, r, 64) for r in (0, 1, 2)]
    assert torch.equal(h[0], h[1])
    moved = (h[2] - h[1]).abs().amax(1) > 1e-6
    assert 0 < int(moved.sum()) < 32


def test_production_draws_are_keyed():
    """``TorchDraws``: a round's batch is a function of (seed, round, ids)."""
    from repro_torch.random import TorchDraws

    _, tc = _cfgs()
    ids = torch.tensor([0, 5, 9])
    a = ts.round_batch(tc, TorchDraws(1, "cpu"), ids, 3, 2, 8)
    b = ts.round_batch(tc, TorchDraws(1, "cpu"), ids, 3, 2, 8)
    c = ts.round_batch(tc, TorchDraws(1, "cpu"), ids, 4, 2, 8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < tc.vocab_size


def test_gather_scatter_sched_rows_match_jax():
    m, bins = 40, 8
    rng = np.random.default_rng(0)
    ids = np.sort(rng.choice(m, 6, replace=False)).astype(np.int32)
    pop_j = jax_init_sched(m, bins, 0.5)
    pop_t = init_scheduler_state(m, bins, 0.5, device="cpu")
    rows_np = dict(
        prev_hist=rng.random((6, bins)).astype(np.float32),
        theta_e=rng.random(6).astype(np.float32),
        warm=rng.random(6) < 0.5,
        last_used=rng.integers(0, 9, 6).astype(np.int32),
        energy_spent=rng.random(6).astype(np.float32),
    )
    rows_j = type(pop_j)(**{k: jnp.asarray(v) for k, v in rows_np.items()},
                         round_index=jnp.asarray(3, jnp.int32))
    rows_t = type(pop_t)(**{k: torch.from_numpy(v) for k, v in rows_np.items()},
                         round_index=torch.tensor(3, dtype=torch.int32))
    out_j = jfog.scatter_sched_rows(pop_j, jnp.asarray(ids), rows_j)
    out_t = tfog.scatter_sched_rows(pop_t, torch.from_numpy(ids.astype(np.int64)), rows_t)
    back_j = jfog.gather_sched_rows(out_j, jnp.asarray(ids))
    back_t = tfog.gather_sched_rows(out_t, torch.from_numpy(ids.astype(np.int64)))
    for name in rows_np:
        np.testing.assert_array_equal(getattr(out_t, name).numpy(),
                                      np.asarray(getattr(out_j, name)))
        np.testing.assert_array_equal(getattr(back_t, name).numpy(), rows_np[name])
    assert int(out_t.round_index) == int(out_j.round_index) == 3
    assert float(pop_t.theta_e[0]) == 0.5  # out of place: the input is unchanged
