"""K3's ``robust_kernel`` design against the JAX package at C = 256
clients, gates int8 and top-k (see ``_robust_design.py``; split from
``test_torch_robust_design.py`` by C, and at C = 256 by gate)."""
import pytest
from _robust_design import AGGS, MASKS, network_matches_jax, one_thread  # noqa: F401


@pytest.mark.parametrize("gate", ["int8", "topk"])
@pytest.mark.parametrize("agg,frac", AGGS, ids=str)
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("c", [256])
def test_network_matches_jax(c, mask_kind, agg, frac, gate):
    network_matches_jax(c, mask_kind, agg, frac, gate)
