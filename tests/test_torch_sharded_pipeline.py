"""The port's sharded server pass (``delta_pipeline_apply_sharded``: K4 on
each rank's rows, one packed all-reduce per tier) on 8 CPU ranks of a
``dist.world`` (gloo), against the JAX package's SINGLE-device kernels in
interpret mode, the comparison the JAX selftests make
(``sharded_selftest.py``, ``fog_selftest.py``).

The ranks run the port's selftests' rank functions: the JAX gate matrix
on client 4 × zero 2 (``sharded_selftest.rank_cases``) and on pod 2 ×
client 2 × zero 2 with the pod axis as a two-node fog tier, plus the flat
combine on those ranks. Each case's rank-0
output is held against ``repro.kernels.delta_pipeline.
delta_pipeline_apply`` (flat) or ``repro.fl.fog.fog_pipeline_apply``
(fog) at the JAX selftests' tolerance, 1e-5 (fedadam 5e-3: its
1e-3-epsilon division amplifies the sum's reassociation error); every
rank's output equal to rank 0's (the replicated epilogue); and each
rank's ledger: one all-reduce of the (P+2,) float32 pack across the
client axis (flat), or one confined to the edge axis and one across the
fog axis (fog), which ``dist.assert_inter_client_contract`` accepts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from _threads import one_thread  # noqa: F401 (autouse)

from repro.fl.fog import fog_pipeline_apply as jax_fog
from repro.kernels.delta_pipeline import delta_pipeline_apply as jax_apply
from repro_torch.dist.world import World
from repro_torch.kernels.delta_pipeline.sharded_selftest import (
    case_args,
    gate_matrix,
    make_inputs,
    rank_cases,
    tolerance,
)

P = 2048
NAMES = [name for name, _ in gate_matrix()]


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results: flat (client 4 × zero 2) and fog (pod 2 ×
    client 2 × zero 2), from one world."""
    with World(8, backend="gloo", device="cpu", timeout=300.0) as w:
        return dict(flat=w.run(rank_cases, (4, 2)), fog=w.run(rank_cases, (2, 2, 2), 2, True))


def jax_reference(name: str, fog_nodes: int):
    case = dict(gate_matrix())[name] if name != "flat" else {}
    args, static = case_args({k: jnp.asarray(v) for k, v in make_inputs().items()}, case)
    if fog_nodes > 1:
        out = jax_fog(*args, fog_nodes=fog_nodes, interpret=True, **static)
    else:
        out = jax_apply(*args, interpret=True, **static)
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))], static


def hold(per_rank, name, fog_nodes):
    ref, static = jax_reference(name, fog_nodes)
    got = per_rank[0][name]["sharded"]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=tolerance(static), err_msg=name)
    for r in per_rank[1:]:
        for a, b in zip(r[name]["sharded"], got):
            np.testing.assert_array_equal(a, b)
    for r in per_rank:
        assert r[name]["pack_bytes"][-1] == 4 * (P + 2)


@pytest.mark.parametrize("name", NAMES)
def test_flat_matches_jax_single_device(ranks, name):
    hold(ranks["flat"], name, 1)
    for r in ranks["flat"]:
        c = r[name]
        assert c["client_all_reduces"] == 1 and len(c["pack_bytes"]) == 1 and c["contract_ok"]


@pytest.mark.parametrize("name", NAMES)
def test_fog_tier_matches_jax_fog_pipeline(ranks, name):
    hold(ranks["fog"], name, 2)
    for r in ranks["fog"]:
        c = r[name]
        assert (c["edge_all_reduces"], c["fog_all_reduces"], c["client_all_reduces"]) == (1, 1, 2)
        assert c["contract_ok"] and c["pack_bytes"] == [4.0 * (P + 2)] * 2


def test_flat_combine_on_the_fog_ranks(ranks):
    """fog_nodes=1 on the pod × client ranks: one all-reduce crossing the
    union, equal to the single-device kernel."""
    hold(ranks["fog"], "flat", 1)
    for r in ranks["fog"]:
        assert r["flat"]["client_all_reduces"] == 1 and r["flat"]["contract_ok"]
