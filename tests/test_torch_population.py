"""The port's population / cohort round against the JAX package.

Cohort sampling, the row gather / scatter, the cohort's scheduler state
and the initial population state are held against the JAX package
exactly (histograms to ``rtol=1e-6``, as in ``test_torch_data.py``).
Whole rounds are held in ``test_torch_population_rounds.py``.

The production provider is checked for what population mode needs of
it: a client's label prior is a function of (seed, client, epoch) alone,
the same in any cohort, and a dense population is the dense round.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_draws import JaxDraws
from _threads import one_thread  # noqa: F401 (autouse)
from test_torch_simulator import SMALL, _np

from repro.core.types import init_population_scheduler_state as jax_init_pop
from repro.data import emnist_like as je
from repro.fl import fog as jfog
from repro.fl.simulator import FedFogSimulator as JaxSimulator
from repro.fl.simulator import SimulatorConfig as JaxConfig
from repro_torch import convert
from repro_torch.core.types import (
    ClientTelemetry,
    SchedulerState,
    init_population_scheduler_state,
)
from repro_torch.data import emnist_like as te
from repro_torch.fl import fog as tfog
from repro_torch.fl.simulator import FedFogSimulator, SimulatorConfig
from repro_torch.random import TorchDraws


@pytest.mark.parametrize("population,cohort", [(1_000_000, 64), (256, 8), (8, 8)])
def test_stratified_cohort_matches_jax(population, cohort):
    draws = JaxDraws(3)
    for r in range(2):
        ids = tfog.stratified_cohort(draws, population, cohort, round=r)
        ref = jfog.stratified_cohort(draws.round_key(r, "cohort"), population, cohort)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ref))
    prod = tfog.stratified_cohort(TorchDraws(3, "cpu"), population, cohort, round=0)
    assert (torch.diff(prod) > 0).all() and 0 <= int(prod.min())
    assert int(prod.max()) < population
    if population == cohort:
        assert torch.equal(prod, torch.arange(cohort))


def _pop_rows(m, rng):
    tel = ClientTelemetry(*(torch.from_numpy(rng.random(m).astype(np.float32))
                            for _ in range(4)))
    sched = init_population_scheduler_state(m, 0.5, device="cpu")
    sched.theta_e.copy_(torch.from_numpy(rng.random(m).astype(np.float32)))
    sched.last_hist_round.copy_(torch.from_numpy(rng.integers(0, 6, m).astype(np.int32)))
    sched.warm.copy_(torch.from_numpy(rng.random(m) < 0.5))
    return tel, sched


def test_gather_scatter_round_trip_is_exact():
    rng = np.random.default_rng(0)
    tel, _ = _pop_rows(40, rng)
    before = {f.name: getattr(tel, f.name).clone() for f in dataclasses.fields(tel)}
    ids = torch.tensor([1, 7, 8, 20, 39])
    rows = tfog.gather_rows(tel, ids)
    assert torch.equal(rows.batt, before["batt"][ids])
    # scatter back what was gathered: nothing changes, in either mode
    back = tfog.scatter_rows(tel, ids, rows)
    assert back is not tel
    assert tfog.scatter_rows(tel, ids, rows, in_place=True) is tel
    for k, v in before.items():
        assert torch.equal(getattr(tel, k), v)
        assert torch.equal(getattr(back, k), v)
    # scatter new rows: exactly those rows change; out of place (the
    # default) leaves ``tel`` as it was, in place writes into it
    new = ClientTelemetry(*(torch.full((5,), float(i)) for i in range(4)))
    keep = torch.ones(40, dtype=torch.bool)
    keep[ids] = False
    out = tfog.scatter_rows(tel, ids, new)
    for k, v in before.items():
        assert torch.equal(getattr(tel, k), v)
    tfog.scatter_rows(tel, ids, new, in_place=True)
    for t in (out, tel):
        assert torch.equal(t.mem[ids], torch.ones(5))
        assert torch.equal(t.mem[keep], before["mem"][keep])


def test_cohort_sched_gather_and_scatter_match_jax():
    rng = np.random.default_rng(1)
    m, k = 50, 62
    _, sched = _pop_rows(m, rng)
    jpop = dataclasses.replace(
        jax_init_pop(m, 0.5), theta_e=jnp.asarray(sched.theta_e.numpy()),
        last_hist_round=jnp.asarray(sched.last_hist_round.numpy()),
        warm=jnp.asarray(sched.warm.numpy()))
    ids_np = np.array([2, 9, 17, 30, 44, 49])
    ids_t, ids_j = torch.from_numpy(ids_np), jnp.asarray(ids_np, jnp.int32)
    cfg_t = te.EmnistLikeConfig(drift_period=2, drift_fraction=0.5, seed=4)
    cfg_j = je.EmnistLikeConfig(drift_period=2, drift_fraction=0.5, seed=4)
    draws = JaxDraws(4)
    hist_t = lambda c, r: te.client_histogram(cfg_t, draws, c.shape[0], r, ids=c)  # noqa: E731
    hist_j = lambda c, r: jax.vmap(lambda a, b: je.client_histogram(cfg_j, a, b))(c, r)  # noqa: E731
    got = tfog.gather_cohort_sched(sched, ids_t, hist_t)
    ref = jfog.gather_cohort_sched(jpop, ids_j, hist_j)
    assert isinstance(got, SchedulerState) and got.prev_hist.shape == (6, k)
    np.testing.assert_allclose(got.prev_hist.numpy(), np.asarray(ref.prev_hist), rtol=1e-6)
    for f in ("theta_e", "warm", "last_used", "energy_spent", "round_index"):
        np.testing.assert_array_equal(_np(getattr(got, f)), np.asarray(getattr(ref, f)))
    rows = dataclasses.replace(got, theta_e=got.theta_e + 1.0,
                               round_index=torch.tensor(3, dtype=torch.int32))
    jrows = dataclasses.replace(ref, theta_e=ref.theta_e + 1.0, round_index=jnp.int32(3))
    new_t = tfog.scatter_cohort_sched(sched, ids_t, rows, 5)
    new_j = jfog.scatter_cohort_sched(jpop, ids_j, jrows, 5)
    for f in ("theta_e", "warm", "last_used", "energy_spent", "last_hist_round",
              "round_index"):
        np.testing.assert_array_equal(_np(getattr(new_t, f)), np.asarray(getattr(new_j, f)))


def test_population_prior_is_the_same_in_any_cohort():
    """Production draws: a client's prior, drift flag and observed
    histogram depend on (seed, client, epoch) only, whichever cohort and
    whichever round of the epoch asks for them."""
    cfg = te.EmnistLikeConfig(drift_period=3, drift_fraction=0.5, seed=2)
    d = TorchDraws(2, "cpu")
    a = torch.tensor([5, 17, 123_456, 999_999])
    b = torch.tensor([17, 40, 999_999])
    for r in (0, 4):
        pa = te.client_label_prior(cfg, d, 4, r, ids=a)
        pb = te.client_label_prior(cfg, d, 3, r + 1, ids=b)
        assert torch.equal(pa[1], pb[0]) and torch.equal(pa[3], pb[2])
        ha = te.client_histogram(cfg, d, 4, r, ids=a)
        hb = te.client_histogram(cfg, d, 3, torch.tensor([r, r + 1, r + 1]), ids=b)
        assert torch.equal(ha[1], hb[0]) and torch.equal(ha[3], hb[2])
    assert not torch.equal(pa[0], pa[1])
    # the dense registry is the same function at ids 0..n-1
    dense = te.client_label_prior(cfg, d, 6, 4)
    assert torch.equal(dense[[2, 5]], te.client_label_prior(
        cfg, d, 2, 4, ids=torch.tensor([2, 5])))


def test_init_state_at_population_matches_jax():
    kw = dict(SMALL, population=300, rounds=3)
    js = JaxSimulator(JaxConfig(**kw))
    ts = FedFogSimulator(SimulatorConfig(**kw), device="cpu", draws=JaxDraws(0))
    assert ts.sched_state.theta_e.shape == (300,)
    for f in ("mips", "bw_up", "rtt_ms", "battery_capacity_j"):
        np.testing.assert_allclose(_np(getattr(ts.profiles, f)),
                                   np.asarray(getattr(js.profiles, f)), rtol=1e-6)
    np.testing.assert_allclose(_np(ts.env["data_sizes"]),
                               np.asarray(js.env["data_sizes"]), rtol=1e-6)
    assert not ts.env["malicious"].any()
    for f in ("theta_e", "warm", "last_used", "energy_spent", "last_hist_round",
              "round_index"):
        np.testing.assert_array_equal(_np(getattr(ts.sched_state, f)),
                                      np.asarray(getattr(js.sched_state, f)))
    for f in ("cpu", "mem", "batt"):
        np.testing.assert_array_equal(_np(getattr(ts.telemetry, f)),
                                      np.asarray(getattr(js.telemetry, f)))
    host = jax.tree.map(np.asarray, (js.env, js.sched_state, js.telemetry))
    _, sched, _ = convert.state_from_jax(*host, device="cpu")
    assert torch.equal(sched.last_hist_round, ts.sched_state.last_hist_round)


def test_dense_population_is_the_dense_round():
    """population == num_clients with one fog is the dense round, bitwise."""
    kw = dict(SMALL, rounds=3, drift_period=2)
    a = FedFogSimulator(SimulatorConfig(**kw), device="cpu")
    b = FedFogSimulator(SimulatorConfig(**kw, population=8, fog_nodes=1), device="cpu")
    assert a.run_scanned() == b.run_scanned()
    for la, lb in zip(a.params, b.params):
        assert torch.equal(la["w"], lb["w"]) and torch.equal(la["b"], lb["b"])


def test_validation_rejects_bad_configs():
    with pytest.raises(ValueError, match="population"):
        FedFogSimulator(SimulatorConfig(**dict(SMALL, population=4)), device="cpu")
    with pytest.raises(ValueError, match="fog_nodes"):
        FedFogSimulator(SimulatorConfig(**dict(SMALL, fog_nodes=3)), device="cpu")
    with pytest.raises(ValueError, match="fedavg"):
        FedFogSimulator(SimulatorConfig(**dict(SMALL, fog_nodes=2, aggregator="median")),
                        device="cpu")
    with pytest.raises(ValueError, match="fog_nodes"):
        FedFogSimulator(SimulatorConfig(**dict(SMALL, fog_nodes=0)), device="cpu")


def test_population_and_fog_default_to_cuda(monkeypatch):
    """A population or fog simulator built without ``device`` asks for the
    card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in (dict(population=1_000_000, num_clients=64, fog_nodes=4),
               dict(fog_nodes=2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            FedFogSimulator(SimulatorConfig(**kw))


def test_production_population_run_trains():
    """Production draws at population 10,000, cohort 16, four fogs: the
    round learns and every metric is finite."""
    cfg = SimulatorConfig(num_clients=16, population=10_000, fog_nodes=4,
                          hidden=(32,), top_k=8, local_batch=16, local_epochs=2,
                          rounds=6, use_pallas_agg=True)
    sim = FedFogSimulator(cfg, device="cpu")
    h = sim.run_scanned()
    assert all(np.isfinite(v).all() for v in h.values())
    assert max(h["num_selected"]) <= 8
    assert h["accuracy"][-1] > h["accuracy"][0] + 0.1
    # only cohort rows were written: at most rounds × cohort clients
    touched = int((sim.sched_state.last_used >= 0).sum())
    assert 0 < touched <= 6 * 16
