"""K3's ``robust_kernel`` design against the JAX package at C = 100
clients (see ``_robust_design.py``; split from
``test_torch_robust_design.py`` by C)."""
import pytest
from _robust_design import AGGS, GATES, MASKS, network_matches_jax, one_thread  # noqa: F401


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("agg,frac", AGGS, ids=str)
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("c", [100])
def test_network_matches_jax(c, mask_kind, agg, frac, gate):
    network_matches_jax(c, mask_kind, agg, frac, gate)
