"""The port's HAR-like task (``repro_torch.data.har_like``) against the
JAX package.

The port takes the JAX package's draws (``_jax_draws.JaxDraws``: the
class signals from ``PRNGKey(seed + 20)``, drift flags, priors and the
per-client gain and phase offset from ``seed + 21 … 23`` folded with
the client id), so the class parameters, priors and labels agree exactly
and the signals to ``atol=2e-5``: the two frameworks' float32 ``sin`` of
arguments up to ~60 rad may round a few ulps apart (|sin| ≤ 1.2 gain,
noise added after). Every case runs for the dense registry and for a
population cohort's ids, with drift off and on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_draws import JaxDraws
from _threads import one_thread  # noqa: F401 (autouse)

from repro.data import har_like as jh
from repro_torch.data import har_like as th
from repro_torch.random import TorchDraws

N = 8
SEED = 3
POP_IDS = np.array([3, 17, 901, 42, 5, 77_000, 123_456, 999_999])
SIG_ATOL = 2e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfgs(drift):
    return (jh.HarLikeConfig(seed=SEED, drift_period=drift),
            th.HarLikeConfig(seed=SEED, drift_period=drift))


def _ids(kind):
    return np.arange(N) if kind == "dense" else POP_IDS


def _tids(kind):
    return None if kind == "dense" else torch.from_numpy(POP_IDS)


def test_class_params_match_jax():
    jc, tc = _cfgs(0)
    for a, b in zip(th._class_params(tc, JaxDraws(SEED)), jh._class_params(jc)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_time_axis_is_jax_linspace():
    want = np.asarray(jnp.linspace(0, 2 * jnp.pi, jh.WINDOW))
    np.testing.assert_array_equal(_np(th._time_axis("cpu")), want)


def test_constants_match_jax():
    assert (th.WINDOW, th.CHANNELS, th.NUM_CLASSES) == (jh.WINDOW, jh.CHANNELS,
                                                          jh.NUM_CLASSES)
    assert th.HarLikeConfig().num_classes == jh.HarLikeConfig().num_classes
    assert ([(f.name, f.default) for f in th.dataclasses.fields(th.HarLikeConfig)]
            == [(f.name, f.default) for f in jh.dataclasses.fields(jh.HarLikeConfig)])


@pytest.mark.parametrize("kind", ["dense", "population"])
@pytest.mark.parametrize("drift,rnd", [(0, 0), (2, 5), (1, 3)])
def test_prior_and_histogram_match_jax(kind, drift, rnd):
    jc, tc = _cfgs(drift)
    ids = _ids(kind)
    want = jax.vmap(lambda c: jh.client_label_prior(jc, c, rnd))(jnp.asarray(ids))
    draws = JaxDraws(SEED)
    got = th.client_label_prior(tc, draws, N, rnd, ids=_tids(kind))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    hist = th.client_histogram(tc, draws, N, rnd, ids=_tids(kind))
    np.testing.assert_array_equal(_np(hist), _np(got))


def test_per_client_rounds_prior_matches_jax():
    """Population drift reference: each member at its own round."""
    jc, tc = _cfgs(2)
    rounds = np.array([0, 1, 2, 3, 4, 5, 6, 7])
    want = jax.vmap(lambda c, r: jh.client_label_prior(jc, c, r))(
        jnp.asarray(POP_IDS), jnp.asarray(rounds))
    got = th.client_label_prior(tc, JaxDraws(SEED), N, torch.from_numpy(rounds),
                                ids=torch.from_numpy(POP_IDS))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["dense", "population"])
@pytest.mark.parametrize("drift,rnd", [(0, 1), (2, 4)])
def test_client_batch_matches_jax(kind, drift, rnd):
    jc, tc = _cfgs(drift)
    ids, batch = _ids(kind), 12
    draws = JaxDraws(SEED)
    k_data = draws.round_key(rnd, "data")
    keys = jax.random.split(k_data, N)
    xj, yj = jax.vmap(lambda c, k: jh.client_batch(jc, c, rnd, k, batch))(
        jnp.asarray(ids), keys)
    xt, yt = th.client_batch(tc, draws, N, rnd, batch, th._class_params(tc, draws),
                             ids=_tids(kind))
    assert xt.dtype == torch.float32 and xt.shape == (N, batch, jh.WINDOW * jh.CHANNELS)
    np.testing.assert_array_equal(_np(yt), np.asarray(yj))
    np.testing.assert_allclose(_np(xt), np.asarray(xj), rtol=0, atol=SIG_ATOL)


def test_eval_batch_matches_jax():
    jc, tc = _cfgs(0)
    draws = JaxDraws(SEED)
    xj, yj = jh.eval_batch(jc, draws.round_key(2, "eval"), 64)
    xt, yt = th.eval_batch(tc, draws, 2, 64, th._class_params(tc, draws))
    np.testing.assert_array_equal(_np(yt), np.asarray(yj))
    np.testing.assert_allclose(_np(xt), np.asarray(xj), rtol=0, atol=SIG_ATOL)


def test_production_client_sites_follow_the_client():
    """With the production provider a client's prior, gain and phase are
    the same in any cohort, at any position."""
    tc = th.HarLikeConfig(seed=1)
    draws = TorchDraws(1, "cpu")
    a = torch.tensor([5, 900_000, 12])
    b = torch.tensor([12, 7, 5, 900_000])
    for site in ("har.gain", "har.phase"):
        ga = draws.client_normal(site, (3, th.CHANNELS), ids=a)
        gb = draws.client_normal(site, (4, th.CHANNELS), ids=b)
        assert torch.equal(ga[0], gb[2]) and torch.equal(ga[1], gb[3])
        assert torch.equal(ga[2], gb[0]) and torch.isfinite(ga).all()
    pa = th.client_label_prior(tc, draws, 3, 0, ids=a)
    pb = th.client_label_prior(tc, draws, 4, 0, ids=b)
    assert torch.equal(pa[1], pb[3])
    np.testing.assert_allclose(_np(pa.sum(-1)), 1.0, rtol=1e-5)
    z = draws.client_normal("har.gain", (4096, 1))
    assert abs(float(z.mean())) < 0.08 and abs(float(z.std()) - 1.0) < 0.05
