"""The port's collective ledger (``repro_torch.dist.collectives``, in place
of the JAX package's HLO accounting).

  * ``CollectiveLog`` on a 4-rank CPU world (gloo, client 2 × zero 2):
    every wrapped call recorded once inside the rank (the deprecated
    ``*_tensor`` spellings call the ``*_single`` ones), with its HLO kind,
    the bytes of the tensor it leaves, its group's global ranks and, when
    timed, its wall ms; logs nest;
  * ``count_axis_crossing`` on the collectives of ``tests/test_dist.py``'s
    synthetic HLO module: its cases (``test_count_axis_crossing``), and
    equal to the JAX function on the same ops for every axis set, kind,
    byte floor and confinement;
  * ``inter_client_all_reduces`` and ``assert_inter_client_contract`` on
    ledgers of a flat and a two-tier fog combine, violations included.
"""
import itertools
import types

import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)
from test_dist import SYNTH_HLO

from repro.dist import analyze_hlo
from repro.dist import count_axis_crossing as jax_count
from repro_torch.dist import (
    CollectiveLog,
    CollectiveStats,
    assert_inter_client_contract,
    count_axis_crossing,
    inter_client_all_reduces,
)
from repro_torch.dist.collectives import CollectiveOp
from repro_torch.dist.meshes import MeshPlan
from repro_torch.dist.world import World


def _fake_mesh(shape: dict):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _synthetic_stats() -> CollectiveStats:
    """The synthetic HLO module's collectives as the port's ledger."""
    return CollectiveStats(tuple(
        CollectiveOp(op.kind, op.bytes, op.groups)
        for op in analyze_hlo(SYNTH_HLO).collectives.ops))


def test_count_axis_crossing_cases():
    """``tests/test_dist.py::test_count_axis_crossing`` on the ledger."""
    a = _synthetic_stats()
    mesh = _fake_mesh({"client": 2, "zero": 2})
    assert count_axis_crossing(a, mesh, axes=("client",)) == 1
    assert count_axis_crossing(a, mesh, axes=("zero",), kinds=("all-gather",)) == 1
    assert count_axis_crossing(a, mesh, axes=("client",), kinds=("all-gather",)) == 0
    assert count_axis_crossing(a, mesh, axes=("client",), min_bytes=1e6) == 0
    assert a.count_by_kind == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1,
                               "collective-permute": 1}
    assert a.bytes_by_kind["reduce-scatter"] == 4 * 16 * 2


@pytest.mark.parametrize("axes,not_axes", [
    (("client",), ()), (("zero",), ()), (("client", "zero"), ()),
    (("client",), ("zero",)), (("zero",), ("client",)), (("pod",), ()),
])
def test_count_axis_crossing_matches_jax(axes, not_axes):
    analysis = analyze_hlo(SYNTH_HLO)
    mesh = _fake_mesh({"client": 2, "zero": 2})
    kinds_sets = [("all-reduce",), ("all-gather",), ("reduce-scatter",),
                  ("collective-permute",), ("all-reduce", "all-gather")]
    for kinds, floor in itertools.product(kinds_sets, [0.0, 200.0, 600.0, 1e6]):
        kw = dict(axes=axes, kinds=kinds, min_bytes=floor, not_axes=not_axes)
        assert count_axis_crossing(_synthetic_stats(), mesh, **kw) == \
            jax_count(analysis, mesh, **kw), kw


def _rules(shape: dict):
    plan = types.SimpleNamespace(client_axes=tuple(a for a in ("pod", "client") if a in shape))
    ways = 1
    for a in plan.client_axes:
        ways *= shape[a]
    return types.SimpleNamespace(mesh=_fake_mesh(shape), plan=plan, client_ways=ways)


def _op(groups, nbytes, kind="all-reduce"):
    return CollectiveOp(kind, float(nbytes), groups)


P = 1000
DELTA = 4 * (P + 2)
FLAT = {"client": 4, "zero": 2}  # ranks r = 2·client + zero
CLIENT_GROUPS = [[0, 2, 4, 6]]
ZERO_GROUP = [[0, 1]]


def test_flat_contract():
    rules = _rules(FLAT)
    log = CollectiveStats((
        _op(ZERO_GROUP, 4 * P), _op(ZERO_GROUP, 4 * P),  # zero gradients: not counted
        _op(CLIENT_GROUPS, DELTA),  # the one packed combine
        _op([list(range(8))], 8),  # a metric scalar over the world
    ))
    assert inter_client_all_reduces(log, rules, P) == (1, 4.0 * P)
    assert assert_inter_client_contract(log, rules, P) == (1, 4.0 * P)
    for bad in ((), (_op(CLIENT_GROUPS, DELTA),) * 2,
                (_op(CLIENT_GROUPS, 4 * P, "all-gather"),)):
        with pytest.raises(AssertionError, match="contract violated"):
            assert_inter_client_contract(CollectiveStats(bad), rules, P)
    # one client rank: nothing to combine, nothing counted
    one = _rules({"client": 1, "zero": 8})
    assert assert_inter_client_contract(CollectiveStats(()), one, P) == (0, 4.0 * P)


def test_fog_contract():
    shape = {"pod": 2, "client": 2, "zero": 2}  # r = 4·pod + 2·client + zero
    rules = _rules(shape)
    edge, fog, union = [[0, 2]], [[0, 4]], [[0, 2, 4, 6]]
    tiers = CollectiveStats((_op(edge, DELTA), _op(fog, DELTA)))
    assert assert_inter_client_contract(tiers, rules, P, fog_nodes=2) == (2, 4.0 * P)
    # a flat combine over the union is not the hierarchy
    with pytest.raises(AssertionError, match="fog-tier"):
        assert_inter_client_contract(CollectiveStats((_op(union, DELTA),)), rules, P,
                                     fog_nodes=2)
    assert assert_inter_client_contract(CollectiveStats((_op(union, DELTA),)), rules, P) \
        == (1, 4.0 * P)
    # an edge tier of one rank: only the fog combine
    thin = _rules({"pod": 2, "client": 1, "zero": 4})
    assert assert_inter_client_contract(CollectiveStats((_op([[0, 4]], DELTA),)), thin, P,
                                        fog_nodes=2) == (1, 4.0 * P)
    with pytest.raises(ValueError, match="fog_nodes=3"):
        assert_inter_client_contract(tiers, rules, P, fog_nodes=3)


def _rank_log(ctx):
    """Every wrapped collective once, on the groups of a client 2 × zero 2
    mesh, under a timed log nested in a plain one."""
    import torch.distributed as dist

    plan = MeshPlan(num_pods=1, num_clients=2, zero=2, model_axes=("tp", "sp"),
                    model_split=(1, 1))
    mesh = plan.build_mesh(ctx.backend, ctx.device)
    with CollectiveLog() as outer:
        with CollectiveLog(timed=True) as log:
            t = torch.full((10,), float(ctx.rank))
            dist.all_reduce(t, group=mesh.group(("client",)))
            dist.all_reduce(t, dist.ReduceOp.SUM, mesh.group(("zero",)))
            dist.broadcast(t, 0)
            out = torch.empty(8)
            dist.all_gather_into_tensor(out, torch.ones(2))
            small = torch.empty(2)
            dist.reduce_scatter_tensor(small, torch.ones(8), group=None)
        dist.all_reduce(torch.ones(3))  # after the inner log: the outer's alone
    n = [len(outer.ops), len(log.ops)]
    return dict(ops=[(op.kind, op.bytes, op.groups, op.ms is not None) for op in log.ops],
                n=n, t=t.tolist(), out=out.tolist(), small=small.tolist(),
                coords=mesh.coords, crossing=count_axis_crossing(log, mesh, ("client",)))


def test_collective_log_on_a_world():
    with World(4, backend="gloo", device="cpu", timeout=120.0) as w:
        ranks = w.run(_rank_log)
    for rank, r in enumerate(ranks):
        c = r["coords"]
        client_group = [c["zero"], 2 + c["zero"]]
        zero_group = [2 * c["client"], 2 * c["client"] + 1]
        assert r["ops"] == [
            ("all-reduce", 40.0, [client_group], True),
            ("all-reduce", 40.0, [zero_group], True),
            ("collective-broadcast", 40.0, [[0, 1, 2, 3]], True),
            ("all-gather", 32.0, [[0, 1, 2, 3]], True),
            ("reduce-scatter", 8.0, [[0, 1, 2, 3]], True),
        ]
        assert r["n"] == [6, 5]
        assert r["out"] == [1.0] * 8 and r["small"] == [4.0, 4.0]
        assert r["crossing"] == 1  # the client group's; the world's ops are of other kinds
    # rank 0's value after client then zero sums, broadcast from rank 0
    assert ranks[0]["t"] == [float(0 + 2 + 1 + 3)] * 10
