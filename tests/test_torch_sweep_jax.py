"""The port's ``run_sweep`` against the JAX package's on the JAX package's
draws: one grid of the four policies by two learning rates (the rates
lifted to data in the JAX package's grouped programs, so four compiled
groups there), two seeds, three rounds, each (point, seed) of the port on
its own ``JaxDraws(seed)``. Held to ``check_three_rounds``' tolerances
(``test_torch_simulator.py``): counts exactly, latencies, energies and
the scheduler means to ``rtol=1e-5`` (``mean_drift`` also ``atol=1e-7``),
accuracy within 2 of the 512 eval samples."""
import numpy as np
from _async_parity import one_thread  # noqa: F401 (autouse)
from _jax_draws import JaxDraws

from repro.fl.simulator import SimulatorConfig as JaxConfig
from repro.sim import run_sweep as jax_run_sweep
from repro_torch.fl.simulator import SimulatorConfig
from repro_torch.sim import run_sweep

SMALL = dict(num_clients=8, hidden=(16,), top_k=4, local_batch=8, local_epochs=2,
             rounds=3, use_pallas_agg=True)
AXES = {"policy": ["fedfog", "rcs", "fogfaas", "vanilla"], "lr": [0.05, 0.1]}
CLOSE = ("round_latency_ms", "orchestration_ms", "energy_j", "mean_utility",
         "mean_battery")


def test_run_sweep_matches_jax():
    seeds = [0, 1]
    rj = jax_run_sweep(JaxConfig(**SMALL), seeds=seeds, axes=AXES)
    rt = run_sweep(SimulatorConfig(**SMALL), seeds=seeds, axes=AXES, device="cpu",
                   draws=JaxDraws)
    assert rt.configs == rj.configs and list(rt.seeds) == list(np.asarray(rj.seeds))
    assert set(rt.history) == set(rj.history)
    for k, hj in rj.history.items():
        ht = rt.history[k]
        assert ht.shape == hj.shape == (8, 2, 3), k
        if k in CLOSE:
            np.testing.assert_allclose(ht, hj, rtol=1e-5, err_msg=k)
        elif k == "mean_drift":
            np.testing.assert_allclose(ht, hj, rtol=1e-5, atol=1e-7)
        elif k == "accuracy":
            np.testing.assert_allclose(ht, hj, atol=2 / 512)
        else:  # num_selected, cold_starts, the fault counters
            np.testing.assert_array_equal(ht, hj, err_msg=k)
    np.testing.assert_allclose(rt.final("accuracy"), rj.final("accuracy"), atol=2 / 512)
