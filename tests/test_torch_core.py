"""repro_torch.core and repro_torch.sim.des against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
and its port. Integers and masks must match exactly, floats to
``rtol=1e-6`` (the two frameworks round a few reductions and
transcendental functions differently in the last bit). Two stated
exceptions: the Eq. 2 KL divergence is a sum of log-ratio terms that
cancel, so it agrees to ``rtol=1e-5`` and the utility built from it to
``atol=1e-6``; sums over clients that cancel towards zero (the
aggregators) carry ``atol=1e-7``, a few float32 ulps of their O(1)
terms. The paper's worked example (§III.G, tests/test_paper_example.py)
is checked on the port directly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro import core as jcore
from repro.sim import des as jdes
from repro_torch import core as tcore
from repro_torch.sim import des as tdes

RTOL = 1e-6


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=RTOL, atol=0.0):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (a.dtype, b.dtype)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _tel(rng, n):
    cols = rng.uniform(0.05, 1.0, size=(4, n)).astype(np.float32)
    return (
        jcore.ClientTelemetry(*map(jnp.asarray, cols)),
        tcore.ClientTelemetry(*map(torch.from_numpy, cols)),
    )


def _sched(rng, n, v, warm_p=0.5):
    hist = rng.dirichlet(np.full(v, 0.5), size=n).astype(np.float32)
    fields = dict(
        prev_hist=hist,
        theta_e=rng.uniform(0.05, 0.9, n).astype(np.float32),
        warm=rng.random(n) < warm_p,
        last_used=rng.integers(-1, 4, n).astype(np.int32),
        energy_spent=rng.random(n).astype(np.float32),
        round_index=np.asarray(4, np.int32),
    )
    return (
        jcore.SchedulerState(**{k: jnp.asarray(x) for k, x in fields.items()}),
        tcore.SchedulerState(**{k: torch.from_numpy(np.array(x)) for k, x in fields.items()}),
    )


# --------------------------------------------------------------------- #
# the paper's worked example (§III.G, §III.K), on the port
# --------------------------------------------------------------------- #
ALPHA = torch.tensor([0.4, 0.3, 0.3])
BETA = torch.tensor([0.4, 0.4, 0.2])
PAPER_TEL = tcore.ClientTelemetry(
    cpu=torch.tensor([0.8, 0.4, 0.9]),
    mem=torch.tensor([0.6, 0.5, 0.7]),
    batt=torch.tensor([0.5, 0.4, 0.8]),
    energy=torch.tensor([0.7, 0.6, 0.9]),
)
PAPER_DRIFT = torch.tensor([0.05, 0.12, 0.02])
PAPER_THR = tcore.Thresholds(
    health=torch.tensor(0.6), energy=torch.tensor(0.5), drift=torch.tensor(0.1)
)


def test_paper_example_health_selection_utility():
    h = tcore.health_score(PAPER_TEL, ALPHA)
    np.testing.assert_allclose(_np(h), [0.65, 0.43, 0.81], atol=1e-6)
    mask = tcore.threshold_mask(h, PAPER_TEL.energy, PAPER_DRIFT, PAPER_THR)
    np.testing.assert_array_equal(_np(mask), [True, False, True])
    u = tcore.utility_score(h, PAPER_TEL.energy, PAPER_DRIFT, BETA)
    np.testing.assert_allclose(float(u[0]), 0.53, atol=1e-5)
    np.testing.assert_allclose(float(u[2]), 0.68, atol=1e-5)
    assert int(tcore.utility_ranking(u)[0]) == 2  # c3 first
    res = tcore.select_clients(h, PAPER_TEL.energy, PAPER_DRIFT, PAPER_THR, BETA)
    np.testing.assert_array_equal(_np(res.mask), [True, False, True])
    assert int(res.num_selected) == 2


def test_paper_example_fedavg_coldstart_epsilon():
    upd = {"w": torch.tensor([[0.2, -0.1], [0.0, 0.0], [0.5, 0.0]])}
    agg = tcore.fedavg_stacked(
        upd, torch.tensor([True, False, True]), torch.tensor([100.0, 250.0, 300.0])
    )
    np.testing.assert_allclose(_np(agg["w"]), [0.425, -0.025], atol=1e-6)
    d = tcore.invocation_delay(torch.tensor([False, False, True]), tcore.ColdStartConfig())
    assert float(d[0]) == 2000.0 and float(d[2]) == 200.0
    eps30 = tcore.epsilon(sigma=0.3, sensitivity=1.1, num_clients=30, delta=1e-5)
    assert eps30 == pytest.approx(0.592, abs=5e-3)
    assert eps30 == jcore.epsilon(0.3, 1.1, 30, 1e-5)
    eps10 = tcore.epsilon(sigma=0.3, sensitivity=1.1, num_clients=10, delta=1e-5)
    assert eps10 == pytest.approx(1.8, abs=0.03)


# --------------------------------------------------------------------- #
# random inputs through both packages
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1])
def test_scores_and_masks_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 16
    jt, tt = _tel(rng, n)
    alpha = np.array([0.4, 0.3, 0.3], np.float32)
    beta = np.array([0.4, 0.4, 0.2], np.float32)
    hj = jcore.health_score(jt, jnp.asarray(alpha))
    ht = tcore.health_score(tt, torch.from_numpy(alpha))
    _close(ht, hj)
    drift = rng.uniform(0, 0.2, n).astype(np.float32)
    uj = jcore.utility_score(hj, jt.energy, jnp.asarray(drift), jnp.asarray(beta))
    ut = tcore.utility_score(ht, tt.energy, torch.from_numpy(drift), torch.from_numpy(beta))
    _close(ut, uj)
    _close(tcore.utility_ranking(ut), jcore.utility_ranking(uj))
    thr_j = jcore.Thresholds(jnp.float32(0.6), jnp.full((n,), 0.5), jnp.float32(0.1))
    thr_t = tcore.Thresholds(torch.tensor(0.6), torch.full((n,), 0.5), torch.tensor(0.1))
    mj = jcore.threshold_mask(hj, jt.energy, jnp.asarray(drift), thr_j)
    mt = tcore.threshold_mask(ht, tt.energy, torch.from_numpy(drift), thr_t)
    _close(mt, mj)
    for k in (None, 1, 3, n):
        _close(tcore.topk_mask(ut, mt, k), jcore.topk_mask(uj, mj, k))
    # ties: equal utilities must keep the lower client index first
    tie = np.repeat(np.float32(0.5), n)
    all_in = np.ones(n, bool)
    _close(
        tcore.topk_mask(torch.from_numpy(tie), torch.from_numpy(all_in), 5),
        jcore.topk_mask(jnp.asarray(tie), jnp.asarray(all_in), 5),
    )
    sj = jcore.select_clients(hj, jt.energy, jnp.asarray(drift), thr_j, jnp.asarray(beta), 4)
    st = tcore.select_clients(ht, tt.energy, torch.from_numpy(drift), thr_t,
                              torch.from_numpy(beta), 4)
    for f in ("mask", "order", "num_selected"):
        _close(getattr(st, f), getattr(sj, f))
    _close(st.utility, sj.utility)


def test_random_selection_mask_from_the_same_permutation():
    import jax

    key = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.permutation(key, 12))
    _close(
        tcore.random_selection_mask(torch.from_numpy(perm), 5),
        jcore.random_selection_mask(key, 12, 5),
    )


def test_drift_and_histograms_match_jax():
    rng = np.random.default_rng(5)
    cur = rng.dirichlet(np.full(62, 0.5), size=8).astype(np.float32)
    prev = rng.dirichlet(np.full(62, 0.5), size=8).astype(np.float32)
    _close(tcore.normalize_histogram(torch.from_numpy(cur)),
           jcore.normalize_histogram(jnp.asarray(cur)))
    _close(tcore.drift_score(torch.from_numpy(cur), torch.from_numpy(prev)),
           jcore.drift_score(jnp.asarray(cur), jnp.asarray(prev)), rtol=1e-5)
    tok = rng.integers(0, 1000, (3, 50)).astype(np.int32)
    _close(tcore.token_histogram(torch.from_numpy(tok), 16, 1000),
           jcore.token_histogram(jnp.asarray(tok), 16, 1000))


@pytest.mark.parametrize("capacity", [None, 3])
def test_container_cache_matches_jax(capacity):
    rng = np.random.default_rng(11)
    n = 12
    cfg_j = jcore.ColdStartConfig(warm_capacity=capacity)
    cfg_t = tcore.ColdStartConfig(warm_capacity=capacity)
    warm = rng.random(n) < 0.5
    last = rng.integers(-1, 5, n).astype(np.int32)
    mask = rng.random(n) < 0.4
    r = np.asarray(5, np.int32)
    wj, lj = jcore.update_container_cache(jnp.asarray(warm), jnp.asarray(last),
                                          jnp.asarray(mask), jnp.asarray(r), cfg_j)
    wt, lt = tcore.update_container_cache(torch.from_numpy(warm), torch.from_numpy(last),
                                          torch.from_numpy(mask), torch.from_numpy(r), cfg_t)
    _close(wt, wj)
    _close(lt, lj)
    _close(tcore.count_cold_starts(torch.from_numpy(mask), torch.from_numpy(warm)),
           jcore.count_cold_starts(jnp.asarray(mask), jnp.asarray(warm)))
    _close(tcore.invocation_delay(torch.from_numpy(warm), cfg_t),
           jcore.invocation_delay(jnp.asarray(warm), cfg_j))


def test_energy_controller_matches_jax():
    from repro.core import energy as jenergy
    from repro_torch.core import energy as tenergy

    rng = np.random.default_rng(2)
    theta = rng.uniform(0.1, 0.9, 16).astype(np.float32)
    e = (rng.random(16) * (rng.random(16) < 0.5)).astype(np.float32)
    cj, ct = jenergy.EnergyModelConfig(), tenergy.EnergyModelConfig()
    _close(tenergy.decay_energy_threshold(torch.from_numpy(theta), torch.from_numpy(e), ct),
           jenergy.decay_energy_threshold(jnp.asarray(theta), jnp.asarray(e), cj))
    _close(tenergy.paper_eq10_literal(torch.from_numpy(theta), torch.from_numpy(e), 0.3),
           jenergy.paper_eq10_literal(jnp.asarray(theta), jnp.asarray(e), 0.3))
    _close(tenergy.battery_drain(torch.from_numpy(theta), torch.from_numpy(e), 2.0),
           jenergy.battery_drain(jnp.asarray(theta), jnp.asarray(e), 2.0))
    _close(tenergy.round_energy(torch.from_numpy(e), torch.from_numpy(theta), ct),
           jenergy.round_energy(jnp.asarray(e), jnp.asarray(theta), cj))


@pytest.mark.parametrize(
    "knobs",
    [dict(), dict(top_k=3), dict(adaptive_energy=False, drift_gating=False,
                                 health_gating=False, top_k=5)],
    ids=["paper", "topk", "ablated"],
)
def test_schedule_round_and_account_energy_match_jax(knobs):
    rng = np.random.default_rng(7)
    n, v = 10, 62
    jt, tt = _tel(rng, n)
    js, ts = _sched(rng, n, v)
    cur = rng.dirichlet(np.full(v, 0.5), size=n).astype(np.float32)
    cfg_j = jcore.SchedulerConfig(theta_d=0.5, **knobs)
    cfg_t = tcore.SchedulerConfig(theta_d=0.5, **knobs)
    dj = jcore.schedule_round(js, jt, jnp.asarray(cur), cfg_j)
    dt = tcore.schedule_round(ts, tt, torch.from_numpy(cur), cfg_t)
    for f in ("mask", "order", "num_selected", "health"):
        _close(getattr(dt.selection, f), getattr(dj.selection, f))
    _close(dt.selection.utility, dj.selection.utility, atol=1e-6)
    _close(dt.selection.drift, dj.selection.drift, rtol=1e-5)
    _close(dt.delays_ms, dj.delays_ms)
    _close(dt.cold_starts, dj.cold_starts)
    for f in dataclasses.fields(ts):
        _close(getattr(dt.new_state, f.name), getattr(dj.new_state, f.name))
    e = (rng.random(n) * _np(dt.selection.mask)).astype(np.float32)
    aj = jcore.account_energy(dj.new_state, jnp.asarray(e), cfg_j)
    at = tcore.account_energy(dt.new_state, torch.from_numpy(e), cfg_t)
    for f in dataclasses.fields(ts):
        _close(getattr(at, f.name), getattr(aj, f.name))


def test_init_scheduler_state_matches_jax():
    sj = jcore.init_scheduler_state(6, 62, 0.4)
    st = tcore.init_scheduler_state(6, 62, 0.4, device="cpu")
    for f in dataclasses.fields(st):
        _close(getattr(st, f.name), getattr(sj, f.name))
    from repro_torch.core.types import static_on

    assert static_on(0.5) and not static_on(0.0) and not static_on(None)


@pytest.mark.parametrize("mask_kind", ["random", "none", "all"])
def test_aggregators_match_jax(mask_kind):
    rng = np.random.default_rng(4)
    n = 7
    tree_np = [
        {"w": rng.normal(size=(n, 5, 3)).astype(np.float32),
         "b": rng.normal(size=(n, 3)).astype(np.float32)},
    ]
    mask = {"random": rng.random(n) < 0.6, "none": np.zeros(n, bool),
            "all": np.ones(n, bool)}[mask_kind]
    sizes = rng.uniform(50, 500, n).astype(np.float32)
    jt = [{k: jnp.asarray(v) for k, v in l.items()} for l in tree_np]
    tt = [{k: torch.from_numpy(v) for k, v in l.items()} for l in tree_np]
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    pairs = [
        (tcore.fedavg_stacked(tt, tm, torch.from_numpy(sizes)),
         jcore.fedavg_stacked(jt, jm, jnp.asarray(sizes))),
        (tcore.median_aggregate(tt, tm), jcore.median_aggregate(jt, jm)),
        (tcore.trimmed_mean_aggregate(tt, tm, 0.2),
         jcore.trimmed_mean_aggregate(jt, jm, 0.2)),
    ]
    for out_t, out_j in pairs:
        for k in ("w", "b"):
            _close(out_t[0][k], out_j[0][k], atol=1e-7)
    _close(tcore.fedavg_weights(tm, torch.from_numpy(sizes)),
           jcore.fedavg_weights(jm, jnp.asarray(sizes)))


def test_gaussian_mechanism_matches_jax_with_its_draws():
    import jax

    from repro.core import privacy as jpriv
    from repro_torch.core import privacy as tpriv

    class OneRound:  # hands the port the normals JAX draws from k_dp
        def __init__(self, key):
            self.key = key

        def normal(self, site, shape, *, segments, round):
            keys = jax.random.split(self.key, len(segments))
            return torch.from_numpy(np.concatenate(
                [np.asarray(jax.random.normal(k, (s,))) for k, s in zip(keys, segments)]
            ))

    rng = np.random.default_rng(9)
    agg = [{"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32)}]
    key = jax.random.PRNGKey(21)
    cfg = dict(sigma=0.5, sensitivity=1.5)
    out_j = jpriv.gaussian_mechanism(
        [{k: jnp.asarray(v) for k, v in l.items()} for l in agg], key,
        jpriv.DPConfig(**cfg))
    out_t = tpriv.gaussian_mechanism(
        [{k: torch.from_numpy(v) for k, v in l.items()} for l in agg], OneRound(key),
        tpriv.DPConfig(**cfg), round=0)
    for k in ("w", "b"):
        _close(out_t[0][k], out_j[0][k])


@pytest.mark.parametrize("policy", ["fedfog", "fogfaas"])
@pytest.mark.parametrize("compression", ["none", "int8"])
def test_round_costs_match_jax(policy, compression):
    from repro.data.telemetry import DeviceProfiles as JProf
    from repro_torch.data.telemetry import DeviceProfiles as TProf

    rng = np.random.default_rng(13)
    n = 12
    prof = dict(
        mips=rng.uniform(3e8, 1.5e9, n), bw_up=rng.uniform(5e5, 6e6, n),
        bw_down=rng.uniform(2e6, 2.4e7, n), rtt_ms=rng.uniform(10, 60, n),
        battery_capacity_j=rng.choice([8e3, 40e3, 15e3], n),
    )
    prof = {k: v.astype(np.float32) for k, v in prof.items()}
    sel = rng.random(n) < 0.5
    warm = rng.random(n) < 0.5
    n_params = 112_766
    up = {"none": 2.0, "int8": 1.0}[compression] * n_params
    args = (6.0 * n_params * 96, up, 2.0 * n_params)
    cj = jdes.RoundCostModel(jdes.FaasSimConfig()).round_costs(
        JProf(**{k: jnp.asarray(v) for k, v in prof.items()}),
        jnp.asarray(sel), jnp.asarray(warm), *args, policy=policy)
    ct = tdes.RoundCostModel(tdes.FaasSimConfig()).round_costs(
        TProf(**{k: torch.from_numpy(v) for k, v in prof.items()}),
        torch.from_numpy(sel), torch.from_numpy(warm), *args, policy=policy)
    for f in jdes.RoundCosts._fields:
        _close(getattr(ct, f), getattr(cj, f))


@pytest.mark.parametrize("x", [0.4, 0.3, 0.1, 0.6, 2000.0, 1.5, 6.0 * 112_766 * 96,
                               1e-30, -0.5, 3.4e38])
def test_scalar_fill_equals_host_tensor(x):
    """``device.scalar`` (a fill, used for the round's Python constants so
    that a round makes no host copy) gives the float32 value that
    ``torch.tensor(x, dtype=float32)`` gives: ``x`` rounded to nearest."""
    from repro_torch.device import scalar

    got = scalar(x, "cpu")
    assert got.dtype == torch.float32 and got.shape == ()
    assert got.view(torch.int32) == torch.tensor(x, dtype=torch.float32).view(torch.int32)
    assert float(got) == float(np.float32(x))


def test_segment_ids_built_once():
    """``fl.fuse.segment_ids`` builds a (sizes, device) pair's ids once (its
    build copies from the host) and hands the same tensor back after."""
    from repro_torch.fl.fuse import segment_ids

    sizes = (3, 1, 4, 2)
    ids = segment_ids(sizes, "cpu")
    assert ids.dtype == torch.int32
    assert ids.tolist() == [0, 0, 0, 1, 2, 2, 2, 2, 3, 3]
    assert segment_ids(list(sizes), torch.device("cpu")) is ids


def test_schedule_round_with_prebuilt_weights():
    """``schedule_round`` given ``config.weights`` built once decides as it
    does when it builds them itself."""
    rng = np.random.default_rng(3)
    n, v = 10, 62
    _, tel = _tel(rng, n)
    _, state = _sched(rng, n, v)
    cur = torch.from_numpy(rng.dirichlet(np.full(v, 0.5), size=n).astype(np.float32))
    cfg = tcore.SchedulerConfig(theta_d=0.5, top_k=3)
    a = tcore.schedule_round(state, tel, cur, cfg)
    b = tcore.schedule_round(state, tel, cur, cfg, cfg.weights("cpu"))
    for f in ("mask", "order", "num_selected", "utility", "health", "drift"):
        assert torch.equal(getattr(a.selection, f), getattr(b.selection, f))
    assert torch.equal(a.delays_ms, b.delays_ms)
