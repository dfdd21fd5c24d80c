"""The card design of K3's median / trimmed-mean route (``robust_kernel``,
a sorting network over each column in registers) emulated on the CPU
(``_robust_network``) and held against the JAX package: C = 1 to 64, the
NaN cases, and the network itself. C = 100 and 256 are in
``test_torch_robust_design_c100.py`` and ``_c256*.py`` (the JAX kernel's
interpret mode makes them most of the run); what each case holds is in
``_robust_design.py``.
"""
import itertools

import numpy as np
import pytest
import torch
from _robust_design import (
    AGGS,
    GATES,
    MASKS,
    network_keeps_nan,
    network_matches_jax,
    one_thread,  # noqa: F401 (autouse)
    same_nan,
)
from _robust_network import key_values, network, network_sort, next_pow2, sort_keys


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("agg,frac", AGGS, ids=str)
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("c", [1, 2, 5, 6, 16, 24, 64])
def test_network_matches_jax(c, mask_kind, agg, frac, gate):
    network_matches_jax(c, mask_kind, agg, frac, gate)


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("agg,frac", AGGS, ids=str)
@pytest.mark.parametrize("mask_kind", ["random", "all"])
@pytest.mark.parametrize("c", [5, 64, 100])
def test_network_keeps_nan(c, mask_kind, agg, frac, gate):
    network_keeps_nan(c, mask_kind, agg, frac, gate)


def test_sort_keys_order_and_inverse():
    """The kernel's keys order floats as torch.sort does, NaN (of either
    sign) after +inf, and map back to the same bits (NaN to a NaN)."""
    vals = torch.tensor([float("-inf"), -3.5, -1e-38, -0.0, 0.0, 1e-45, 2.0,
                         float("inf"), float("nan"), -float("nan")])
    keys = sort_keys(vals)
    assert bool((keys[1:] >= keys[:-1]).all()) and int(keys[3]) < int(keys[4])
    back = key_values(keys)
    assert torch.equal(back[:8].view(torch.int32), vals[:8].view(torch.int32))
    assert bool(back[8:].isnan().all())
    rng = np.random.default_rng(7)
    col = rng.standard_normal((64, 33)).astype(np.float32)
    col[rng.random((64, 33)) < 0.1] = np.nan
    col[rng.random((64, 33)) < 0.1] = 0.0
    col[rng.random((64, 33)) < 0.05] = -np.inf
    v = torch.from_numpy(col)
    assert same_nan(network_sort(v), torch.sort(v, dim=0).values)


@pytest.mark.parametrize("n2", [2, 4, 8, 16])
def test_network_sorts_every_zero_one_input(n2):
    """The zero-one principle: a comparator network that sorts every 0/1
    input sorts every input."""
    cols = torch.arange(1 << n2)
    v = ((cols[None, :] >> torch.arange(n2)[:, None]) & 1).to(torch.float32)
    s = network_sort(v)
    assert torch.equal(s, torch.sort(v, dim=0).values)


@pytest.mark.parametrize("n2,pairs,stages", [(1, 0, 0), (2, 1, 1), (8, 19, 6),
                                             (64, 543, 21), (256, 3839, 36)])
def test_network_size_and_disjoint_stages(n2, pairs, stages):
    """Batcher's odd-even merge sort: its known sizes, and pairs within a
    stage touch disjoint rows (so a stage is one vectorised step here, and
    the kernel's order within it does not matter)."""
    net = network(n2)
    assert len(net) == stages and sum(len(p) for _, _, p in net) == pairs
    for _, _, prs in net:
        rows = list(itertools.chain.from_iterable(prs))
        assert len(rows) == len(set(rows)) and all(a < b for a, b in prs)
    assert next_pow2(n2) == n2 and next_pow2(n2 + 1) == 2 * n2
