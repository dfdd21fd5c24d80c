"""Fault injection and recovery at the port's fog tier against the JAX
simulator, three rounds from one state with the JAX package's draws (the
``faults.*`` sites from ``fold_in(k, 8)``; tolerances in
``test_torch_simulator.py``, whose ``check_three_rounds`` runs it, with
every fault counter held exactly): fog outages at two fogs, with and
without failover, dense and at population 64."""
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


@pytest.mark.parametrize("failover", [False, True], ids=["lost", "failover"])
def test_fog_outage_at_two_fogs_matches_jax(failover):
    """K4 on blocks whose weights are all zero when their fog is dark."""
    _check(dict(fog_outage_rate=0.5, fog_failover=failover, crash_rate=0.2),
           fog_nodes=2)


def test_population_fog_faults_match_jax():
    _check(dict(fog_outage_rate=0.3, crash_rate=0.3, max_retries=1), population=64,
           fog_nodes=2)
