"""Robust aggregation under attack in the port's dense round against the
JAX simulator, three rounds from one state with the JAX package's draws
(tolerances in ``test_torch_simulator.py``, whose ``check_three_rounds``
runs it): K3's median / trimmed route (``robust_kernel``) on the kernel
path, and ``core.aggregation`` on the reference path."""
import pytest
from test_torch_simulator import check_three_rounds
from _threads import one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("attack,aggregator,pallas", [
    ("noise", "median", True),
    ("model_replacement", "trimmed", True),
    ("model_replacement", "median", False),
], ids=["noise-median-kernel", "replacement-trimmed-kernel",
        "replacement-median-reference"])
def test_attack_robust_matches_jax(attack, aggregator, pallas):
    check_three_rounds(attack=attack, attack_fraction=0.25, aggregator=aggregator,
                       use_pallas_agg=pallas)
