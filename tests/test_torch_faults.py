"""The port's fault layer (``repro_torch.sim.faults``) against the JAX
package, and the port's own recovery invariants.

``plan_round`` takes the JAX package's draws (``_jax_draws.JaxDraws``:
the round key's ``fold_in(k, 8)`` plan half, split into the attempt
chain, partition, fog and corruption keys), while the JAX ``plan_round``
gets that plan key itself. Counters, masks and the skip flag must then
agree exactly, ``chain_ms``, ``attempts`` and ``round_ms`` to
``rtol=1e-5``. Inputs (admitted, cold, per-client latency) are made from
a seed with numpy.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _jax_draws import JaxDraws

from repro.sim.faults import config as jcfg
from repro.sim.faults import inject as jinj
from repro_torch.fl.simulator import FedFogSimulator, SimulatorConfig
from repro_torch.random import TorchDraws
from repro_torch.sim.faults import config as tcfg
from repro_torch.sim.faults import inject as tinj

N = 16
SEED = 2
SMALL = dict(num_clients=8, hidden=(16,), top_k=4, local_batch=8, local_epochs=2,
             use_pallas_agg=True)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_plan_key(seed, rnd):
    key = jax.random.PRNGKey(seed + 100)
    for _ in range(rnd + 1):
        key, k = jax.random.split(key)
    return jax.random.split(jax.random.fold_in(k, 8))[0]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    admitted = rng.random(N) < 0.75
    cold = rng.random(N) < 0.5
    per_client = np.where(admitted, rng.uniform(200, 1500, N), 0.0).astype(np.float32)
    return admitted, cold, per_client


def test_config_fields_match_jax():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]  # noqa: E731
    assert fields(tcfg.FaultConfig) == fields(jcfg.FaultConfig)
    assert tcfg.RATE_FIELDS == jcfg.RATE_FIELDS
    assert tcfg.SCALE_FIELDS == jcfg.SCALE_FIELDS
    assert tinj.COUNTER_KEYS == jinj.COUNTER_KEYS


@pytest.mark.parametrize("kw", [
    {}, dict(corrupt_scale=0.5, max_retries=3, quorum_frac=0.5),
    dict(crash_rate=0.1), dict(fog_outage_rate=0.2), dict(deadline_ms=100.0),
    dict(partition_rate=1e-6),
], ids=["inert", "scales_only", "crash", "outage", "deadline", "tiny_rate"])
def test_active_matches_jax(kw):
    assert tcfg.active(tcfg.FaultConfig(**kw)) == jcfg.active(jcfg.FaultConfig(**kw))
    assert tcfg.active(None) is jcfg.active(None) is False


@pytest.mark.parametrize("kw", [
    dict(crash_rate=1.5), dict(quorum_frac=-0.1), dict(max_retries=-1),
    dict(deadline_ms=0.0), dict(backoff_mult=0.0),
])
def test_validate_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        jcfg.validate(jcfg.FaultConfig(**kw))
    with pytest.raises(ValueError):
        tcfg.validate(tcfg.FaultConfig(**kw))


@pytest.mark.parametrize("base,mult", [(100.0, 2.0), (500.0, 1.7), (33.3, 3.0)])
def test_backoff_matches_jax(base, mult):
    tc, jc = (m.FaultConfig(backoff_base_ms=base, backoff_mult=mult) for m in (tcfg, jcfg))
    for a in range(1, 6):
        t = tcfg.backoff_ms(tc, a)
        assert isinstance(t, float) and t == float(np.float32(t))  # a float32 value
        np.testing.assert_allclose(t, float(jcfg.backoff_ms(jc, a)), rtol=1e-5)


PLAN_CASES = {
    "crash": (dict(crash_rate=0.4, max_retries=2), 1),
    "drop": (dict(drop_rate=0.5, max_retries=1), 1),
    "timeout": (dict(timeout_rate=0.8), 1),
    "partition": (dict(partition_rate=1.0, partition_frac=0.5, max_retries=1), 1),
    "corrupt": (dict(corrupt_rate=0.5), 1),
    "outage": (dict(fog_outage_rate=0.6), 4),
    "outage_failover": (dict(fog_outage_rate=0.6, fog_failover=True), 4),
    "deadline": (dict(crash_rate=0.5, max_retries=3, backoff_base_ms=400.0,
                      deadline_ms=2000.0), 1),
    "quorum": (dict(crash_rate=0.7, quorum_frac=0.6), 2),
    "all": (dict(timeout_rate=0.3, crash_rate=0.3, drop_rate=0.1, corrupt_rate=0.2,
                 partition_rate=0.5, fog_outage_rate=0.3, fog_failover=True,
                 max_retries=2, deadline_ms=2500.0, quorum_frac=0.25), 2),
}


@pytest.mark.parametrize("name", list(PLAN_CASES))
@pytest.mark.parametrize("rnd", [0, 3])
def test_plan_round_matches_jax(name, rnd):
    kw, fogs = PLAN_CASES[name]
    admitted, cold, per_client = _inputs(10 * rnd + len(name))
    jp = jinj.plan_round(jcfg.FaultConfig(**kw), _jax_plan_key(SEED, rnd), admitted,
                         cold, per_client, fog_nodes=fogs)
    tp = tinj.plan_round(tcfg.FaultConfig(**kw), JaxDraws(SEED),
                         torch.from_numpy(admitted), torch.from_numpy(cold),
                         torch.from_numpy(per_client), fog_nodes=fogs, round=rnd)
    for f in ("arrived", "corrupt", "skip"):
        np.testing.assert_array_equal(_np(getattr(tp, f)), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    for f in ("chain_ms", "attempts", "round_ms"):
        np.testing.assert_allclose(_np(getattr(tp, f)), np.asarray(getattr(jp, f)),
                                   rtol=1e-5, err_msg=f)
    assert {k: int(v) for k, v in tp.counters.items()} == {
        k: int(v) for k, v in jp.counters.items()}
    c = tp.counters
    assert int(c["fault_dispatched"]) == int(c["fault_completed"]) + int(
        c["fault_terminal"]) + int(c["fault_lost"])


def test_plan_round_conserves_over_random_configs():
    """Production draws, 40 random configurations: dispatched = completed
    + terminal + lost, arrivals within the admitted cohort, attempts at
    most the retry cap + 1."""
    rng = np.random.default_rng(0)
    for i in range(40):
        fc = tcfg.FaultConfig(
            timeout_rate=rng.random(), crash_rate=rng.random(), drop_rate=rng.random() / 2,
            corrupt_rate=rng.random(), partition_rate=rng.random(),
            fog_outage_rate=rng.random(), fog_failover=bool(rng.random() < 0.5),
            max_retries=int(rng.integers(0, 4)),
            deadline_ms=None if rng.random() < 0.5 else float(rng.uniform(300, 3000)),
            quorum_frac=rng.random())
        admitted, cold, per_client = (torch.from_numpy(x) for x in _inputs(i))
        p = tinj.plan_round(fc, TorchDraws(i, "cpu"), admitted, cold, per_client,
                            fog_nodes=int(rng.choice([1, 2, 4])), round=i)
        c = {k: int(v) for k, v in p.counters.items()}
        assert c["fault_dispatched"] == c["fault_completed"] + c["fault_terminal"] + \
            c["fault_lost"]
        assert not bool((p.arrived & ~admitted).any())
        assert float(p.attempts.max()) <= fc.max_retries + 1
        assert c["fault_dispatched"] == int(admitted.sum())


def test_inert_config_is_the_unfaulted_round_bitwise(monkeypatch):
    """faults=None and an all-inert FaultConfig run the same round: the
    gate is off, no fault is planned, and the histories are bitwise
    equal (as the JAX package's test_faults_off_bitwise_sync_scanned)."""
    base = FedFogSimulator(SimulatorConfig(**SMALL, rounds=3), device="cpu")
    inert = FedFogSimulator(SimulatorConfig(**SMALL, rounds=3,
                                            faults=tcfg.FaultConfig(max_retries=2)),
                            device="cpu")
    assert not base._faults_on and not inert._faults_on

    def planned(*args, **kwargs):
        raise AssertionError("an inert FaultConfig planned faults")

    monkeypatch.setattr(inert, "_plan_faults", planned)
    assert base.run_scanned() == inert.run_scanned()


@pytest.mark.parametrize("threads", [None, 1], ids=["default_threads", "one_thread"])
def test_inert_config_final_params_bitwise(threads):
    """faults=None and an inert FaultConfig also end with bitwise equal
    parameters: every block of the round is a pure function of its key.
    A whole-suite run on a loaded 8-core CPU has seen the default-thread
    case differ once (an open fault, ROADMAP queue 3); the one-thread case
    pins the intra-op split of the CPU kernels, to tell the two apart."""
    before = torch.get_num_threads()
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        sims = [FedFogSimulator(SimulatorConfig(**SMALL, rounds=3, faults=fc), device="cpu")
                for fc in (None, tcfg.FaultConfig(max_retries=2))]
        hists = [s.run_scanned() for s in sims]
    finally:
        torch.set_num_threads(before)
    assert hists[0] == hists[1]
    for a, b in zip(*(s.params for s in sims)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("pop", [None, 64], ids=["dense", "population"])
def test_quorum_skip_carries_model_bitwise(pop):
    """A crash storm below quorum: no round aggregates, the parameters
    stay bitwise those before the run, and every dispatching round is
    marked skipped."""
    fc = tcfg.FaultConfig(crash_rate=1.0, quorum_frac=0.5)
    sim = FedFogSimulator(SimulatorConfig(**SMALL, rounds=3, faults=fc, population=pop),
                          device="cpu")
    before = [{k: v.clone() for k, v in layer.items()} for layer in sim.params]
    h = sim.run_scanned()
    for a, b in zip(before, sim.params):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    disp = np.asarray(h["fault_dispatched"])
    assert disp.sum() > 0
    np.testing.assert_array_equal(h["round_skipped"], (disp > 0).astype(float))


@pytest.mark.parametrize("pop", [None, 64], ids=["dense", "population"])
def test_fog_failover_reroutes_instead_of_losing(pop):
    kw = dict(SMALL, rounds=3, fog_nodes=2, population=pop)
    lose = FedFogSimulator(SimulatorConfig(
        **kw, faults=tcfg.FaultConfig(fog_outage_rate=1.0)), device="cpu").run_scanned()
    assert sum(lose["fog_outages"]) > 0 and sum(lose["fault_lost"]) > 0
    safe = FedFogSimulator(SimulatorConfig(
        **kw, faults=tcfg.FaultConfig(fog_outage_rate=1.0, fog_failover=True)),
        device="cpu").run_scanned()
    assert sum(safe["fault_lost"]) == 0 and sum(safe["fault_failed_over"]) > 0
    for h in (lose, safe):
        for r in range(3):
            assert h["fault_dispatched"][r] == (h["fault_completed"][r]
                                                + h["fault_terminal"][r]
                                                + h["fault_lost"][r])


def test_retries_and_backoff_fold_into_round_totals():
    base = FedFogSimulator(SimulatorConfig(**SMALL, rounds=3), device="cpu").run_scanned()
    fc = tcfg.FaultConfig(crash_rate=0.9, max_retries=3, backoff_base_ms=5000.0)
    h = FedFogSimulator(SimulatorConfig(**SMALL, rounds=3, faults=fc),
                        device="cpu").run_scanned()
    assert sum(h["fault_retries"]) > 0 and h["total_fault_retries"] == sum(
        h["fault_retries"])
    assert sum(h["round_latency_ms"]) > sum(base["round_latency_ms"])
    assert sum(h["energy_j"]) > sum(base["energy_j"])
