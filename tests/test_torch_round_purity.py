"""The port's ``_round`` is a function of its arguments, as the JAX
package's ``_round`` / ``_round_population`` are: run twice from one
state it gives equal metrics and leaves that state unchanged. In
population mode the cohort's rows are scattered out of place; only the
run loops, which own their carry, ask ``_round`` to write in place, and
that path gives the same round."""
import dataclasses

import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro_torch.fl.simulator import FedFogSimulator, SimulatorConfig

SMALL = dict(num_clients=8, hidden=(16,), top_k=4, local_batch=8, local_epochs=1,
             use_pallas_agg=True)


def _snapshot(obj):
    return {f.name: getattr(obj, f.name).clone() for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


def _assert_same(obj, snap):
    for k, v in snap.items():
        assert torch.equal(getattr(obj, k), v), k


def _round(sim, state, r, **kw):
    params, sched, tel = state
    return sim._round(sim.env, params, sched, tel, r, **kw)


@pytest.mark.parametrize("population,fog_nodes", [(256, 1), (256, 2), (None, 1)])
def test_round_replays_and_leaves_its_inputs_unchanged(population, fog_nodes):
    _check_replay(SimulatorConfig(population=population, fog_nodes=fog_nodes, **SMALL))


@pytest.mark.parametrize("population", [None, 256], ids=["dense", "population"])
def test_faulted_attacked_har_round_replays_and_leaves_its_inputs_unchanged(population):
    """The robustness path's round: HAR, the noise attack, and faults
    with corruption, retries and fog outages at two fogs."""
    from repro_torch.sim.faults import FaultConfig

    fc = FaultConfig(crash_rate=0.3, max_retries=1, corrupt_rate=0.3,
                     fog_outage_rate=0.5, quorum_frac=0.2)
    _check_replay(SimulatorConfig(population=population, fog_nodes=2, task="har",
                                  attack="noise", attack_fraction=0.25, faults=fc,
                                  **SMALL))


def _check_replay(cfg):
    population = cfg.population
    sim = FedFogSimulator(cfg, device="cpu")
    sim._ensure_state()
    state = (sim.params, sim.sched_state, sim.telemetry)
    before = (_snapshot(sim.sched_state), _snapshot(sim.telemetry))
    params_before = [{k: v.clone() for k, v in layer.items()} for layer in sim.params]
    runs = []
    for r in (2, 2):  # twice from the same state, the same round
        out = _round(sim, state, r)
        _assert_same(sim.sched_state, before[0])
        _assert_same(sim.telemetry, before[1])
        for layer, ref in zip(sim.params, params_before):
            for k in ref:
                assert torch.equal(layer[k], ref[k])
        runs.append(out)
    (p1, s1, t1, m1), (p2, s2, t2, m2) = runs
    assert m1.keys() == m2.keys()
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    _assert_same(s2, _snapshot(s1))
    _assert_same(t2, _snapshot(t1))
    # the run loops' in-place path: the same round, written into the state
    p3, s3, t3, m3 = _round(sim, state, 2, in_place=True)
    for k in m1:
        assert torch.equal(m1[k], m3[k]), k
    _assert_same(s3, _snapshot(s1))
    _assert_same(t3, _snapshot(t1))
    if population is not None:
        assert s3.theta_e is sim.sched_state.theta_e  # written in place
        assert t3.batt is sim.telemetry.batt
