"""Fault injection and recovery in the port's round against the JAX
simulator, three rounds from one state with the JAX package's draws (the
``faults.*`` sites from ``fold_in(k, 8)``; tolerances in
``test_torch_simulator.py``, whose ``check_three_rounds`` runs it, with
every fault counter held exactly). Dense rounds; the fog tier is in
``test_torch_simulator_fog_faults.py``."""
import pytest
from test_torch_simulator import SMALL, check_three_rounds
from _threads import one_thread  # noqa: F401 (autouse)

from repro.fl.simulator import FedFogSimulator as JaxSimulator
from repro.fl.simulator import SimulatorConfig as JaxConfig
from repro.sim.faults import FaultConfig as JaxFaultConfig
from repro_torch.sim.faults import FaultConfig


def _check(kw, **overrides):
    """Each simulator takes its own package's ``FaultConfig(**kw)``."""
    js = JaxSimulator(JaxConfig(**dict(SMALL, rounds=3, faults=JaxFaultConfig(**kw),
                                       **overrides)))
    check_three_rounds(js=js, faults=FaultConfig(**kw), **overrides)


@pytest.mark.parametrize("kw", [
    dict(crash_rate=0.5, max_retries=2, timeout_rate=0.3, drop_rate=0.1,
         corrupt_rate=0.3, partition_rate=0.5),
    dict(crash_rate=0.5, max_retries=2, backoff_base_ms=500.0, deadline_ms=4000.0,
         quorum_frac=0.25),
    dict(crash_rate=1.0, quorum_frac=0.5),
], ids=["mixed", "storm-deadline-quorum", "quorum-skip"])
def test_dense_faults_match_jax(kw):
    _check(kw)
