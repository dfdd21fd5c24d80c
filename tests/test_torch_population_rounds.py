"""Population rounds of the port against the JAX simulator: three rounds
from one state through ``check_three_rounds`` (``test_torch_simulator.py``,
whose docstring states the tolerances). Both simulators start from the
JAX package's population state, carried across by ``repro_torch.convert``,
and the port takes the JAX package's draws with the cohort's client ids
folded in. The cases with two fogs are in ``test_torch_fog.py``; each
file stays well under a minute on one core.
"""
import pytest
from test_torch_simulator import check_three_rounds
from _threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("drift_period", [0, 2])
def test_three_population_rounds_match_jax(drift_period):
    """Population 256, cohort 8, one fog: K3 on the kernel path, with and
    without drift injection (``fog_nodes=2`` is in test_torch_fog.py)."""
    check_three_rounds(population=256, fog_nodes=1, drift_period=drift_period)


def test_resampled_clients_recompute_their_drift_reference():
    """Population 16, cohort 8: strata of width 2, so clients come back
    in later rounds and their drift reference is recomputed at the round
    they were last seen, across drift epochs; the reference (non-kernel)
    fog path and label-flip attackers placed over the population."""
    check_three_rounds(population=16, fog_nodes=2, drift_period=1,
                       use_pallas_agg=False, attack="label_flip",
                       attack_fraction=0.25)
