"""The port's sweep runner (``repro_torch.sim.sweep``) and
``aot_scanned`` / ``run_scanned_with``.

  * ``_grid`` and the structural / numeric factoring equal the JAX
    package's on its own tests' configurations, and round-trip;
  * ``SweepResult``'s reductions equal the JAX package's on the same
    arrays;
  * a sweep's seed slice equals the standalone run bit for bit, on both
    engines and for a faulted point (held against ``run_scanned()``, not
    against the JAX sweep, whose faulted slice is R4 in ROADMAP.md);
    grouped equals ungrouped bit for bit;
  * queue overflow raises, the async dispatch budget is honoured,
    ``devices=2`` raises naming ROADMAP item 11;
  * ``aot_scanned`` / ``run_scanned_with`` equal ``run_scanned()``, and a
    tap or a program of another configuration, device or round count
    raises ``ValueError``.

The sweep against the JAX sweep on the JAX package's draws is in
``test_torch_sweep_jax.py``.
"""
import dataclasses

import numpy as np
import pytest
from _async_parity import one_thread  # noqa: F401 (autouse)

from repro.core.scheduler import SchedulerConfig as JaxScheduler
from repro.fl.simulator import SimulatorConfig as JaxConfig
from repro.sim import sweep as jsweep
from repro.sim.events import AsyncConfig as JaxAsyncConfig
from repro.sim.events import ChurnConfig as JaxChurn
from repro.sim.faults import FaultConfig as JaxFaults
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fl.simulator import FedFogSimulator, SimulatorConfig
from repro_torch.obs import MemoryTracker, MetricTap
from repro_torch.sim import SweepResult, run_sweep
from repro_torch.sim import sweep
from repro_torch.sim.events import AsyncConfig, AsyncFedFogSimulator, ChurnConfig
from repro_torch.sim.faults import FaultConfig

SMALL = dict(num_clients=8, hidden=(16,), top_k=4, local_batch=8, local_epochs=2,
             rounds=3, use_pallas_agg=True)


def _cfg(**kw):
    return SimulatorConfig(**dict(SMALL, **kw))


# Configurations of the JAX package's sweep tests (test_simulator_engine,
# test_fog_population, test_faults), as constructor kwargs; scheduler and
# faults as dicts of fields.
SIM_CASES = {
    "base": {},
    "lr-topk": dict(lr=0.03, top_k=2),
    "rcs": dict(policy="rcs", lr=0.05),
    "thetas": dict(scheduler=dict(theta_h=0.5, theta_e=0.4)),
    "trimmed": dict(aggregator="trimmed", trim_fraction=0.2),
    "median-plain": dict(aggregator="median", use_pallas_agg=False),
    "dp-on": dict(dp_sigma=0.05, clip_norm=1.0),
    "top_k-none": dict(top_k=None),
    "population-fog": dict(population=64, fog_nodes=2),
    "faults": dict(faults=dict(crash_rate=0.3, max_retries=2, deadline_ms=4000.0)),
    "faults-off": dict(faults=dict()),
}
ASYNC_CASES = {
    "cohort": ("", {}),
    "fedasync": ("fedasync", dict(straggler_sigma=0.5, dispatch_interval_ms=200.0)),
    "fedbuff": ("fedbuff", dict(k=3, horizon_ms=2000.0)),
    "churn": ("fedbuff", dict(k=2, churn=dict(arrival_rate=0.2, departure_rate=0.8))),
    "churn-half": ("fedbuff", dict(k=2, churn=dict(departure_rate=0.5, death_batt=0.1))),
}


def _sim(pkg, kw):
    sim_cls, sched_cls, faults_cls = ((JaxConfig, JaxScheduler, JaxFaults) if pkg == "jax"
                                      else (SimulatorConfig, SchedulerConfig, FaultConfig))
    kw = dict(SMALL, **kw)
    if "scheduler" in kw:
        kw["scheduler"] = sched_cls(**kw["scheduler"])
    if "faults" in kw:
        kw["faults"] = faults_cls(**kw["faults"])
    return sim_cls(**kw)


def _async(pkg, ctor, kw):
    async_cls, churn_cls = ((JaxAsyncConfig, JaxChurn) if pkg == "jax"
                            else (AsyncConfig, ChurnConfig))
    kw = dict(kw)
    if "churn" in kw:
        kw["churn"] = churn_cls(**kw["churn"])
    if not ctor:
        return async_cls(**kw)
    args = (kw.pop("k"),) if "k" in kw else ()
    return getattr(async_cls, ctor)(*args, **kw)


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_factor_sim_matches_jax(case):
    struct, num = sweep._factor_sim(_sim("torch", SIM_CASES[case]))
    jstruct, jnum = jsweep._factor_sim(_sim("jax", SIM_CASES[case]))
    assert num == jnum
    assert dataclasses.asdict(struct) == dataclasses.asdict(jstruct)
    assert sweep._apply_numeric(struct, num) == _sim("torch", SIM_CASES[case])


@pytest.mark.parametrize("case", list(ASYNC_CASES))
def test_factor_async_matches_jax(case):
    ctor, kw = ASYNC_CASES[case]
    struct, num = sweep._factor_async(_async("torch", ctor, kw))
    jstruct, jnum = jsweep._factor_async(_async("jax", ctor, kw))
    assert num == jnum
    assert dataclasses.asdict(struct) == dataclasses.asdict(jstruct)
    assert sweep._apply_async_numeric(struct, num) == _async("torch", ctor, kw)


def test_signatures_group_like_jax():
    """Points that differ in numeric values share a signature; a policy, an
    aggregator or the kernel route opens a new one, in both packages."""
    def sig(mod, pkg, kw):
        return repr(mod._factor_sim(_sim(pkg, kw))[0])

    cases = [{}, dict(lr=0.07), dict(top_k=2), dict(policy="rcs"),
             dict(aggregator="median"), dict(use_pallas_agg=False),
             dict(dp_sigma=0.1), dict(dp_sigma=0.2)]
    ours = [sig(sweep, "torch", c) for c in cases]
    theirs = [sig(jsweep, "jax", c) for c in cases]
    assert [ours.index(s) for s in ours] == [theirs.index(s) for s in theirs]
    assert len(set(ours)) == 5


@pytest.mark.parametrize("axes,cases", [
    (None, None), ({"lr": [0.1, 0.2], "policy": ["fedfog", "rcs"]}, None),
    ({"lr": [0.1]}, [{"top_k": 2}, {"policy": "rcs"}]),
])
def test_grid_like_jax(axes, cases):
    assert sweep._grid(axes, cases) == jsweep._grid(axes, cases)


@pytest.mark.parametrize("with_valid", (False, True))
def test_sweep_result_methods_match_jax(with_valid):
    rng = np.random.RandomState(0)
    g, s, r = 3, 4, 5
    names = ("accuracy", "energy_j", "round_latency_ms", "cold_starts")
    history = {k: rng.rand(g, s, r) for k in names}
    if with_valid:
        valid = np.zeros((g, s, r))
        for i in range(g):
            for j in range(s):
                valid[i, j, : rng.randint(0, r + 1)] = 1.0
        history["valid"] = valid
    ours = SweepResult([{}] * g, np.arange(s), r, history)
    theirs = jsweep.SweepResult([{}] * g, np.arange(s), r, history)
    np.testing.assert_array_equal(ours.metric("energy_j"), theirs.metric("energy_j"))
    np.testing.assert_array_equal(ours.final("accuracy"), theirs.final("accuracy"))
    for a, b in zip(ours.mean_ci("accuracy"), theirs.mean_ci("accuracy")):
        np.testing.assert_array_equal(a, b)
    for reduce in ("final", "sum", "mean", "max"):
        for a, b in zip(ours.mean_std("energy_j", reduce), theirs.mean_std("energy_j", reduce)):
            np.testing.assert_array_equal(a, b)
    for k, v in ours.stats(1).items():
        np.testing.assert_array_equal(v, theirs.stats(1)[k])
    one = SweepResult([{}], np.arange(1), r, {"accuracy": history["accuracy"][:1, :1]})
    assert np.isnan(one.mean_ci("accuracy")[1]).all()


# --------------------------------------------------------------------- #
# sync sweeps
# --------------------------------------------------------------------- #
def _assert_history_equal(a, b):
    assert set(a.history) == set(b.history)
    for k in a.history:
        np.testing.assert_array_equal(a.history[k], b.history[k], err_msg=k)


def test_seed_slice_equals_standalone_bitwise():
    """Seed s of every point equals ``FedFogSimulator(replace(cfg_i,
    seed=s)).run_scanned()`` bit for bit, a faulted point included."""
    cfg = _cfg()
    cases = [{"policy": "rcs", "lr": 0.1},
             {"faults": FaultConfig(crash_rate=0.3, max_retries=2, deadline_ms=4000.0)}]
    res = run_sweep(cfg, seeds=[0, 1], cases=cases, device="cpu")
    assert res.metric("accuracy").shape == (2, 2, cfg.rounds)
    for g, over in enumerate(cases):
        for si, s in enumerate((0, 1)):
            h = FedFogSimulator(dataclasses.replace(cfg, seed=s, **over),
                                device="cpu").run_scanned()
            for k in res.history:
                np.testing.assert_array_equal(res.history[k][g, si], np.asarray(h[k]),
                                              err_msg=f"{over}/{s}/{k}")
    assert res.metric("fault_retries")[1].sum() > 0
    assert not np.array_equal(res.metric("accuracy")[:, 0], res.metric("accuracy")[:, 1])


def test_grouped_equals_ungrouped_bitwise():
    """Grouping is an execution strategy: on a structural × numeric grid
    the grouped sweep (each point rebuilt from its signature and numeric
    values) equals the per-point sweep bit for bit; it forms fewer groups
    than points and reports no compiles."""
    cfg = _cfg()
    cases = [{"policy": "fedfog", "lr": 0.03}, {"policy": "fedfog", "lr": 0.07},
             {"policy": "fedfog", "lr": 0.03, "top_k": 2}, {"policy": "rcs", "lr": 0.05},
             {"scheduler": SchedulerConfig(theta_h=0.5, theta_e=0.4)},
             {"scheduler": SchedulerConfig(theta_h=0.7, theta_e=0.6)}]
    tm: dict = {}
    tracker = MemoryTracker()
    grouped = run_sweep(cfg, seeds=[0, 1], cases=cases, timings=tm, tracker=tracker,
                        device="cpu")
    per_point = run_sweep(cfg, seeds=[0, 1], cases=cases, group=False, device="cpu")
    _assert_history_equal(grouped, per_point)
    assert grouped.configs == per_point.configs == cases
    assert tm["n_groups"] == 2 < len(cases)
    assert tm["n_compiles"] == tm["cache_hits"] == tm["disk_hits"] == 0
    assert tm["trace_s"] == tm["compile_s"] == tm["load_s"] == 0.0 < tm["exec_s"]
    assert [r["event"] for r in tracker.rows] == ["sweep_group"] * 2
    assert tracker.summaries[0]["n_points"] == len(cases)


def test_sweep_reductions_shapes():
    res = run_sweep(_cfg(), seeds=[0, 1, 2], device="cpu")
    mean, ci = res.mean_ci("accuracy")
    assert mean.shape == ci.shape == (1, 3)
    m, s = res.mean_std("energy_j", reduce="sum")
    assert m.shape == s.shape == (1,)
    stats = res.stats(0)
    assert stats["final_accuracy"].shape == (3,)
    np.testing.assert_allclose(stats["total_energy_j"], res.metric("energy_j")[0].sum(-1))


def test_sweep_arguments_raise():
    with pytest.raises(NotImplementedError, match="item 11"):
        run_sweep(_cfg(), seeds=[0, 1], devices=2, device="cpu")
    with pytest.raises(ValueError, match="seeds"):
        run_sweep(_cfg(), seeds=[], device="cpu")
    with pytest.raises(ValueError, match="engine"):
        run_sweep(_cfg(), seeds=[0], engine="loop", device="cpu")


# --------------------------------------------------------------------- #
# async sweeps
# --------------------------------------------------------------------- #
def test_async_sweep_slice_equals_standalone():
    """Seed s of an async sweep point equals the standalone engine's run on
    every valid flush, bit for bit; ``final`` takes the last valid flush;
    grouped equals ungrouped."""
    cfg = _cfg()
    acfg = AsyncConfig.fedbuff(2, dispatch_interval_ms=800.0, straggler_sigma=0.2)
    kw = dict(engine="async", async_cfg=acfg, axes={"buffer_k": [1, 2]}, device="cpu")
    res = run_sweep(cfg, seeds=[0, 2], **kw)
    _assert_history_equal(res, run_sweep(cfg, seeds=[0, 2], group=False, **kw))
    assert not np.array_equal(res.metric("accuracy")[:, 0], res.metric("accuracy")[:, 1])
    for g, over in enumerate(res.configs):
        for si, s in enumerate((0, 2)):
            h = AsyncFedFogSimulator(
                dataclasses.replace(cfg, seed=s),
                dataclasses.replace(acfg, max_dispatches=cfg.rounds, **over),
                device="cpu").run()
            nf = h["num_flushes"]
            valid = res.metric("valid")[g, si]
            assert valid[:nf].all() and not valid[nf:].any()
            for k in ("accuracy", "t_ms", "num_aggregated", "energy_j", "mean_staleness"):
                np.testing.assert_array_equal(res.metric(k)[g, si, :nf], np.asarray(h[k]))
            assert res.final("accuracy")[g, si] == h["accuracy"][-1]
            assert res.metric("completions")[g, si] == h["num_completions"]


def test_async_sweep_surfaces_queue_overflow():
    with pytest.raises(RuntimeError, match="overflow"):
        run_sweep(_cfg(num_clients=6, top_k=6, hidden=(8,)), seeds=[0], engine="async",
                  async_cfg=AsyncConfig(queue_capacity=2), device="cpu")


def test_async_sweep_respects_dispatch_budget():
    """async_cfg.max_dispatches wins when no rounds= is given; rounds=
    overrides it."""
    cfg = _cfg(rounds=6)
    res = run_sweep(cfg, seeds=[0], engine="async", async_cfg=AsyncConfig(max_dispatches=2),
                    device="cpu")
    assert int((res.metric("valid")[0, 0] > 0).sum()) == 2
    res = run_sweep(cfg, seeds=[0], rounds=3, engine="async",
                    async_cfg=AsyncConfig(max_dispatches=2), device="cpu")
    assert int((res.metric("valid")[0, 0] > 0).sum()) == 3


# --------------------------------------------------------------------- #
# aot_scanned / run_scanned_with
# --------------------------------------------------------------------- #
def test_aot_scanned_matches_run_scanned():
    """The program of one simulator runs a same-shape peer of another seed:
    its history equals the peer's ``run_scanned()`` bit for bit."""
    cfg = _cfg(drift_period=2)
    prog = FedFogSimulator(cfg, device="cpu", defer_state=True).aot_scanned()
    assert prog.rounds == cfg.rounds and prog.device == "cpu"
    for s in (0, 1):
        c = dataclasses.replace(cfg, seed=s)
        a = FedFogSimulator(c, device="cpu").run_scanned()
        b = FedFogSimulator(c, device="cpu").run_scanned_with(prog)
        assert a == b


def test_aot_scanned_refuses_taps_and_other_programs():
    with pytest.raises(ValueError, match="tap"):
        FedFogSimulator(_cfg(), device="cpu",
                        tap=MetricTap(MemoryTracker(), every=1)).aot_scanned()
    prog = FedFogSimulator(_cfg(), device="cpu").aot_scanned()
    with pytest.raises(ValueError, match="configuration"):
        FedFogSimulator(_cfg(hidden=(8,)), device="cpu").run_scanned_with(prog)
    with pytest.raises(ValueError, match="configuration"):
        FedFogSimulator(_cfg(lr=0.2), device="cpu").run_scanned_with(prog)
    with pytest.raises(ValueError, match="round count"):
        FedFogSimulator(_cfg(), device="cpu").run_scanned_with(prog, rounds=2)
    with pytest.raises(ValueError, match="device"):
        FedFogSimulator(_cfg(), device="cpu").run_scanned_with(
            dataclasses.replace(prog, device="cuda"))
