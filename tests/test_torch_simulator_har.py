"""The HAR-like task in the port's round against the JAX simulator, three
rounds from one state with the JAX package's draws (HAR's class signals,
priors, gain and phase offsets from ``seed + 20 … 23``; tolerances in
``test_torch_simulator.py``, whose ``check_three_rounds`` runs it): the
1152→16→6 MLP through K3's mean route, dense and at population 64."""
from test_torch_simulator import check_three_rounds
from _threads import one_thread  # noqa: F401 (autouse)


def test_har_dense_matches_jax():
    check_three_rounds(task="har")


def test_har_population_drift_label_flip_matches_jax():
    """A cohort of 8 out of 64, drift flags every round, and label-flip
    attackers placed over the population."""
    check_three_rounds(task="har", population=64, drift_period=1,
                       attack="label_flip", attack_fraction=0.25)
