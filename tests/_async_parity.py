"""The port's async engine against the JAX package's, on the JAX package's
draws (``_jax_draws.JaxDraws`` replays the engine's key chain).

``check_async(sim_kw, async_kw)`` builds the same configuration in both
packages, runs ``run()`` on each and holds the histories to
``check_three_rounds``' tolerances (``test_torch_simulator.py``):

  * counts exactly: flushes, dispatches, completions, aggregated and
    admitted clients, cold starts, churn losses, every fault counter;
  * virtual times, latencies and energies to ``rtol=1e-5``; the mean
    staleness (a ratio of small integers) to ``rtol=1e-6``;
  * accuracy within 2 of the 512 eval samples;
  * the final parameters (from a second run of each loop) to
    ``rtol=1e-4, atol=1e-6``, the batteries to ``rtol=1e-5``.

``sim_kw`` may hold ``faults`` as a dict of ``FaultConfig`` fields;
``async_kw`` may name a constructor (``"ctor": "fedbuff"``, with
``"k"``) and hold ``churn`` as a dict of ``ChurnConfig`` fields.
"""
import warnings

import numpy as np
import torch
from _jax_draws import JaxDraws
from _threads import one_thread  # noqa: F401 (re-exported: autouse in importers)

from repro.fl.simulator import SimulatorConfig as JaxConfig
from repro.sim.events import AsyncConfig as JaxAsyncConfig
from repro.sim.events import AsyncFedFogSimulator as JaxAsync
from repro.sim.events import ChurnConfig as JaxChurn
from repro.sim.faults import FaultConfig as JaxFaults
from repro_torch.fl.simulator import SimulatorConfig
from repro_torch.sim.events import AsyncConfig, AsyncFedFogSimulator, ChurnConfig
from repro_torch.sim.faults import FaultConfig

SMALL = dict(num_clients=8, hidden=(16,), top_k=4, local_batch=8, local_epochs=2,
             rounds=3, use_pallas_agg=True)

EXACT = ("num_aggregated", "cold_starts", "num_flushes", "num_dispatches",
         "num_completions", "lost_inflight", "dispatch_num_admitted",
         "dispatch_num_available", "dispatch_cold_starts", "total_cold_starts")
CLOSE = ("t_ms", "update_latency_ms", "energy_j", "virtual_time_ms", "dispatch_t_ms",
         "total_energy_j")
ACCURACY = ("accuracy", "final_accuracy", "peak_accuracy")


def build(pkg, sim_kw, async_kw):
    """(SimulatorConfig, AsyncConfig) of ``pkg`` ("jax" or "torch")."""
    sim_cls, async_cls, churn_cls, faults_cls = (
        (JaxConfig, JaxAsyncConfig, JaxChurn, JaxFaults) if pkg == "jax"
        else (SimulatorConfig, AsyncConfig, ChurnConfig, FaultConfig))
    kw = dict(SMALL, **sim_kw)
    if "faults" in kw:
        kw["faults"] = faults_cls(**kw["faults"])
    akw = dict(async_kw)
    ctor = akw.pop("ctor", None)
    if "churn" in akw:
        akw["churn"] = churn_cls(**akw["churn"])
    if ctor is None:
        acfg = async_cls(**akw)
    else:
        args = (akw.pop("k"),) if "k" in akw else ()
        acfg = getattr(async_cls, ctor)(*args, **akw)
    return sim_cls(**kw), acfg


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_async(sim_kw, async_kw, seed=0):
    """Run both engines from ``seed`` and compare (module docstring).
    Returns the port's history."""
    jcfg, jacfg = build("jax", dict(sim_kw, seed=seed), async_kw)
    tcfg, tacfg = build("torch", dict(sim_kw, seed=seed), async_kw)
    js = JaxAsync(jcfg, jacfg)
    ts = AsyncFedFogSimulator(tcfg, tacfg, device="cpu", draws=JaxDraws(seed))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # churn losses warn
        hj, ht = js.run(seed), ts.run(seed)
    assert set(ht) == set(hj)  # one history schema
    exact = [k for k in hj if k in EXACT or k.startswith(("fault_", "fog_", "total_fault",
                                                           "total_rounds"))]
    for k in exact:
        assert ht[k] == hj[k], (k, ht[k], hj[k])
    for k in CLOSE:
        np.testing.assert_allclose(ht[k], hj[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(ht["mean_staleness"], hj["mean_staleness"], rtol=1e-6)
    for k in ACCURACY:
        np.testing.assert_allclose(ht[k], hj[k], atol=2 / 512, err_msg=k)
    covered = set(exact) | set(CLOSE) | set(ACCURACY) | {"mean_staleness"}
    assert covered == set(hj), set(hj) - covered
    # the final state, from the compiled loop already traced by run()
    jf = js._scan_jit(js.init_state(seed))
    tf = ts._scan_events(ts.init_state(seed))
    for lj, lt in zip(jf.params, tf.params):
        for name in ("w", "b"):
            np.testing.assert_allclose(_np(lt[name]), np.asarray(lj[name]),
                                       rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(_np(tf.tel.batt), np.asarray(jf.tel.batt), rtol=1e-5)
    np.testing.assert_array_equal(_np(tf.sched.warm), np.asarray(jf.sched.warm))
    np.testing.assert_array_equal(_np(tf.busy), np.asarray(jf.busy))
    assert tf.flush_idx == int(jf.flush_idx) and tf.dispatch_idx == int(jf.dispatch_idx)
    return ht
