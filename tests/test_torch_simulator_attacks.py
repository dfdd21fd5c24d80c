"""The §IV.D attacks in the port's dense round against the JAX simulator,
three rounds from one state with the JAX package's draws (the attacks'
normals from the round key's ``attack`` split; tolerances in
``test_torch_simulator.py``, whose ``check_three_rounds`` runs it).
Table V's attacks under Eq. 6 FedAvg through the fused kernel (K3's
mean route); the robust aggregators are in
``test_torch_simulator_robust.py``."""
import pytest
from test_torch_simulator import check_three_rounds
from _threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("attack", ["noise", "model_replacement", "dropout"])
def test_attack_fedavg_matches_jax(attack):
    """A quarter of the clients attack; dropout also shrinks the mask that
    ``num_selected`` and the costs see."""
    check_three_rounds(attack=attack, attack_fraction=0.25)
