"""Robust aggregation through the port's fused kernel against the JAX
simulator, three rounds from one state with the JAX package's draws
(tolerances in ``test_torch_simulator.py``, whose ``check_three_rounds``
runs it)."""
from test_torch_simulator import check_three_rounds
from _threads import one_thread  # noqa: F401 (autouse)


def test_pallas_median_dp_matches_jax():
    """The kernel's median with DP noise, clipping, int8 compression and
    label-flip attackers (drift injection is held in
    test_torch_data.py)."""
    check_three_rounds(aggregator="median", dp_sigma=0.05, clip_norm=1.0,
                       compression="int8", attack="label_flip",
                       attack_fraction=0.25)
