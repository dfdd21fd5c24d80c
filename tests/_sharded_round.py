"""JAX-side helpers of the sharded LM round's parity tests
(``test_torch_sharded_round*.py``): the 8-rank world, the JAX
single-device round jitted once per configuration, the port's
single-process round recording its draws, and the checks of the ranks'
results (``_dist_cases.rank_round``)."""
import jax
import numpy as np
import pytest
import torch
from _dist_cases import Recording, rank_round
from _jax_draws import JaxDraws
from _lm_parity import (
    BASE,
    F32,
    batches,
    configs,
    hold_leaves,
    hold_metrics,
    hold_state,
)

from repro.configs import get_reduced as jax_reduced
from repro.fl import init_fl_state as jax_init
from repro.fl import make_round_fn as jax_make
from repro.models import build_model as jax_build
from repro_torch import convert, tree
from repro_torch.configs import get_reduced
from repro_torch.dist.world import World
from repro_torch.fl import make_round_fn
from repro_torch.models import build_model

INT8_TOL = dict(rtol=1e-4, atol=5e-4)  # as test_torch_lm_round_more.py
ROUNDS = 2
GATES = {
    "plain": dict(server_optimizer="fedavg"),
    "legacy": dict(server_optimizer="fedavgm"),
    "full": dict(server_optimizer="fedavgm", clip_norm=1.0, dp_sigma=1e-3,
                 compression="int8"),
}


@pytest.fixture(scope="module")
def world():
    with World(8, backend="gloo", device="cpu", timeout=300.0) as w:
        yield w


@pytest.fixture(scope="module")
def models():
    return (jax_build(jax_reduced("llama3.2-1b", **F32)),
            build_model(get_reduced("llama3.2-1b", **F32)))


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX single-device round's (initial state, final state, metrics)
    per configuration, each jitted once: its reference path serves both
    of the port's paths."""
    cache = {}

    def get(over):
        key = repr(sorted(over.items()))
        if key not in cache:
            jm = models[0]
            jfl, _ = configs(over)
            js = js0 = jax_init(jm, jfl, jax.random.PRNGKey(0))
            jr = jax.jit(jax_make(jm, jfl, flops_per_client_round=1e9))
            jms = []
            for b in batches(jfl.num_clients, ROUNDS):
                js, m = jr(js, {k: jax.numpy.asarray(v) for k, v in b.items()})
                jms.append(jax.tree.map(np.asarray, m))
            cache[key] = (jax.tree.map(np.asarray, js0), js, jms)
        return cache[key]

    return get


def run_case(world, models, jax_runs, over, pallas):
    """JAX single-device (reference path), the port's single-process and
    the sharded round (``use_pallas_agg=pallas``) from the same JAX state
    over ``ROUNDS`` batches."""
    tm = models[1]
    js0, js, jms = jax_runs(over)
    over = dict(over, use_pallas_agg=pallas)
    _, tfl = configs(over)
    bs = batches(tfl.num_clients, ROUNDS)
    ts0 = convert.fl_state_from_jax(tm.cfg, js0, device="cpu")
    rec = Recording(JaxDraws(0, fl_rng=js0.rng))
    tr = make_round_fn(tm, tfl, flops_per_client_round=1e9, draws=rec)
    ts, tms = ts0, []
    for b in bs:
        with torch.no_grad():
            ts, m = tr(ts, {k: torch.from_numpy(v.copy()) for k, v in b.items()})
        tms.append(m)
    spec = dict(fl=dict(BASE, **over), state=ts0, batches=bs, calls=rec.calls)
    return js, jms, ts, tms, world.run(rank_round, spec)


def hold_ranks(js, jms, ts, tms, ranks, tol, *, zero_ops, contract=1):
    """Hold rank 0 against JAX and the single-process round, every rank
    against rank 0, and each rank's ledger: ``contract`` delta-sized
    all-reduces across the client ranks a round (two with a fog tier),
    ``zero_ops`` gradient all-reduces confined to the zero axis."""
    r0 = ranks[0]
    hold_metrics(jms, r0["metrics"])
    hold_state(js, r0["state"], tol)
    hold_metrics([{k: v.numpy() for k, v in m.items()} for m in tms], r0["metrics"])
    host = jax.tree.map(lambda x: x.numpy(), [ts.params, ts.server_mu])
    hold_leaves(host[0], r0["state"].params, tol)
    if ts.server_mu is not None:
        hold_leaves(host[1], r0["state"].server_mu, tol, what="server_mu")
    for r in ranks[1:]:  # the state is replicated, bit for bit
        for a, b in zip(tree.leaves([r0["state"].params, r0["state"].server_mu]),
                        tree.leaves([r["state"].params, r["state"].server_mu])):
            assert (a is None and b is None) or torch.equal(a, b)
        assert r["metrics"] == r0["metrics"]
    for r in ranks:
        assert r["contract"] == [contract] * ROUNDS
        assert r["zero_ops"] == [zero_ops] * ROUNDS
        assert r["zero_crossing_clients"] == [0] * ROUNDS
    assert sorted(r["slots"] for r in ranks) == sorted(
        [(i, i + 1) for i in range(4)] * 2)
    assert all(m["slot_participation"] > 0 for m in r0["metrics"])
