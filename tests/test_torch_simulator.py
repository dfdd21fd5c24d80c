"""The port's dense synchronous round against the JAX simulator.

Both simulators start from one state: the JAX package's ``init_state``,
carried across by ``repro_torch.convert``. The port takes the JAX
package's own draws (``_jax_draws.JaxDraws``), so three rounds of
``run()`` can be compared metric by metric:

  * ``num_selected`` and ``cold_starts`` exactly;
  * latency, energy and the ``mean_*`` metrics to ``rtol=1e-5``;
    ``mean_drift`` also to ``atol=1e-7``: without injected drift the KL
    divergence is zero up to rounding (~1e-8), which no relative
    tolerance can hold;
  * accuracy within 2 of the 512 eval samples;
  * final parameters to ``rtol=1e-4, atol=1e-6``.

The port's own ``run_scanned()`` must equal its ``run()``. This file runs
the slice's own configuration; ``test_torch_simulator_variants.py`` and
``test_torch_simulator_reference.py`` run other gates of the round
through ``check_three_rounds`` (one JAX configuration per file keeps each
file under a minute on one core).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _jax_draws import JaxDraws
from _threads import one_thread  # noqa: F401 (autouse)

from repro.fl.simulator import FedFogSimulator as JaxSimulator
from repro.fl.simulator import SimulatorConfig as JaxConfig
from repro_torch import convert
from repro_torch.fl.simulator import FedFogSimulator, SimulatorConfig

SMALL = dict(num_clients=8, hidden=(16,), top_k=4, local_batch=8, local_epochs=2,
             use_pallas_agg=True)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_from_jax(js, **kw):
    ts = FedFogSimulator(SimulatorConfig(**kw), device="cpu",
                         draws=JaxDraws(kw.get("seed", 0)), defer_state=True)
    host = jax.tree.map(np.asarray, (js.env, js.params, js.sched_state, js.telemetry))
    env, params, sched, tel = host
    ts.env, ts.sched_state, ts.telemetry = convert.state_from_jax(
        env, sched, tel, device="cpu"
    )
    ts.params = convert.params_from_jax(params, device="cpu")
    return ts


def check_three_rounds(js=None, **overrides):
    """Three rounds of ``run()`` on the JAX simulator ``js`` (built from
    ``SMALL`` + ``overrides`` when None) and on the port started from
    its state, compared at the tolerances of the module docstring."""
    kw = dict(SMALL, rounds=3, **overrides)
    js = js if js is not None else JaxSimulator(JaxConfig(**kw))
    ts = _port_from_jax(js, **kw)
    hj, ht = js.run(), ts.run()
    assert set(ht) == set(hj)  # one history schema
    for k in ("num_selected", "cold_starts"):
        assert ht[k] == hj[k], k
    for k in ("round_latency_ms", "orchestration_ms", "energy_j", "mean_utility",
              "mean_battery", "total_energy_j", "mean_latency_ms"):
        np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(ht["mean_drift"], hj["mean_drift"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ht["accuracy"], hj["accuracy"], atol=2 / 512)
    for k in [k for k in hj if k.startswith(("fault_", "total_fault", "fog_", "round_s"))]:
        assert ht[k] == hj[k], k
    for lj, lt in zip(js.params, ts.params):
        for name in ("w", "b"):
            np.testing.assert_allclose(_np(lt[name]), np.asarray(lj[name]),
                                       rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(_np(ts.sched_state.warm), np.asarray(js.sched_state.warm))
    np.testing.assert_allclose(_np(ts.telemetry.batt), np.asarray(js.telemetry.batt),
                               rtol=1e-5)


@pytest.fixture(scope="module")
def jax_small():
    """The JAX simulator at the slice's small configuration, with its
    initial state kept (``run()`` replaces the state attributes)."""
    js = JaxSimulator(JaxConfig(**SMALL, rounds=3))
    return js, (js.env, js.params, js.sched_state, js.telemetry)


def test_init_state_matches_jax(jax_small):
    js, (env, params, sched, tel) = jax_small
    ts = FedFogSimulator(SimulatorConfig(**SMALL, rounds=3), device="cpu",
                         draws=JaxDraws(0))
    for lj, lt in zip(params, ts.params):
        for name in ("w", "b"):
            np.testing.assert_array_equal(_np(lt[name]), np.asarray(lj[name]))
    for f in ("mips", "bw_up", "bw_down", "rtt_ms", "battery_capacity_j"):
        np.testing.assert_allclose(_np(getattr(ts.profiles, f)),
                                   np.asarray(getattr(env["profiles"], f)), rtol=1e-6)
    np.testing.assert_allclose(_np(ts.env["data_sizes"]),
                               np.asarray(env["data_sizes"]), rtol=1e-6)
    np.testing.assert_array_equal(_np(ts.env["malicious"]), np.asarray(env["malicious"]))
    assert ts.env["data_seed"] == int(env["data_seed"])
    for f in dataclasses.fields(ts.sched_state):
        np.testing.assert_allclose(_np(getattr(ts.sched_state, f.name)),
                                   np.asarray(getattr(sched, f.name)), rtol=1e-6)
    for f in ("cpu", "mem", "batt", "energy"):
        np.testing.assert_array_equal(_np(getattr(ts.telemetry, f)),
                                      np.asarray(getattr(tel, f)))


def test_three_rounds_match_jax(jax_small):
    """The slice's path: Eq. 6 FedAvg through the fused kernel."""
    js, state0 = jax_small
    js.env, js.params, js.sched_state, js.telemetry = state0
    check_three_rounds(js=js)


def test_run_scanned_equals_run():
    """The scanned engine moves the stacked metrics to the host once; it
    runs the same round on the same keyed draws, so the histories and
    the final state are identical."""
    cfg = SimulatorConfig(**SMALL, rounds=3, drift_period=2, dp_sigma=0.05)
    a = FedFogSimulator(cfg, device="cpu")
    b = FedFogSimulator(cfg, device="cpu")
    ha, hb = a.run(), b.run_scanned()
    assert ha == hb
    for la, lb in zip(a.params, b.params):
        assert torch.equal(la["w"], lb["w"]) and torch.equal(la["b"], lb["b"])
    assert torch.equal(a.telemetry.batt, b.telemetry.batt)


def test_production_run_trains():
    """Production draws: the slice learns, and round 0 pays a cold start
    for every selected client."""
    cfg = SimulatorConfig(num_clients=16, hidden=(32,), top_k=8, local_batch=16,
                          local_epochs=2, rounds=6, use_pallas_agg=True)
    h = FedFogSimulator(cfg, device="cpu").run_scanned()
    assert h["cold_starts"][0] == h["num_selected"][0] > 0
    assert all(np.isfinite(v).all() for v in h.values())
    assert h["accuracy"][-1] > h["accuracy"][0] + 0.1


@pytest.mark.parametrize("override", [dict(task="mnist"), dict(attack="sybil"),
                                      dict(aggregator="krum")],
                         ids=["task", "attack", "aggregator"])
def test_unknown_configuration_values_raise(override):
    with pytest.raises(ValueError, match="unknown"):
        FedFogSimulator(SimulatorConfig(**SMALL, **override), device="cpu")


def test_default_device_is_cuda():
    """Entry points run on CUDA unless asked for the CPU; without a card
    they raise instead of moving to the CPU."""
    from repro_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            FedFogSimulator(SimulatorConfig(**SMALL))
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")


def _cpu_state():
    sim = FedFogSimulator(SimulatorConfig(**SMALL), device="cpu")
    return sim.env, sim.sched_state, sim.telemetry


@pytest.mark.parametrize("entry", [
    "FedFogSimulator", "params_from_jax", "state_from_jax", "init_scheduler_state",
])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """With no device given, each entry point asks for the card and raises
    when there is none, rather than building its tensors on the CPU."""
    from repro_torch.core.types import init_scheduler_state

    calls = {
        "FedFogSimulator": lambda: FedFogSimulator(SimulatorConfig(**SMALL)),
        "params_from_jax": lambda: convert.params_from_jax(
            [{"w": np.ones((2, 3), np.float32), "b": np.zeros(3, np.float32)}]
        ),
        "state_from_jax": lambda: convert.state_from_jax(*_cpu_state()),
        "init_scheduler_state": lambda: init_scheduler_state(4, 62),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
