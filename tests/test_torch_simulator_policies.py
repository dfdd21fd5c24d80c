"""The simulator's FogFaaS and vanilla baselines (§IV.B) in the port's
dense round against the JAX simulator, three rounds from one state with
the JAX package's draws (tolerances in ``test_torch_simulator.py``,
whose ``check_three_rounds`` runs it): every client alive participates,
and FogFaaS pays its platform's orchestration and keeps no container
warm."""
import pytest
from test_torch_simulator import check_three_rounds
from _threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("policy", ["fogfaas", "vanilla"])
def test_policy_matches_jax(policy):
    check_three_rounds(policy=policy)
