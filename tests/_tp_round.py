"""JAX-side helpers of the tensor-parallel round's parity tests
(``test_torch_tp_round*.py``): the 4-rank world, the JAX single-device
round jitted once per (config, gates), the port's single-process round
recording its draws, and the checks of the ranks' results
(``_tp_cases.rank_tp_round``)."""
import functools

import jax
import numpy as np
import pytest
import torch
from _dist_cases import Recording
from _jax_draws import JaxDraws
from _lm_parity import BASE, batches, configs, hold_leaves, hold_metrics, hold_state
from _tp_cases import rank_tp_round, torch_cfg

from repro.configs import get_reduced as jax_reduced
from repro.fl import init_fl_state as jax_init
from repro.fl import make_round_fn as jax_make
from repro.models import build_model as jax_build
from repro_torch import convert, tree
from repro_torch.dist.world import World
from repro_torch.fl import make_round_fn
from repro_torch.models import build_model

ROUNDS = 2
GATES = {
    "plain": dict(server_optimizer="fedavg"),
    "legacy": dict(server_optimizer="fedavgm"),
    "full": dict(server_optimizer="fedavgm", clip_norm=1.0, dp_sigma=1e-3,
                 compression="int8"),
}


@pytest.fixture(scope="module")
def world():
    with World(4, backend="gloo", device="cpu", timeout=300.0) as w:
        yield w


@functools.lru_cache(maxsize=None)
def jax_round(arch: str, gates: str):
    """The JAX single-device round's (initial state, final state, metrics)
    on ``ROUNDS`` batches, jitted once per (arch, gates): its reference
    path serves both of the port's paths and every split."""
    jm = jax_build(jax_reduced(arch, param_dtype="float32", compute_dtype="float32"))
    jfl, _ = configs(GATES[gates])
    js = js0 = jax_init(jm, jfl, jax.random.PRNGKey(0))
    jr = jax.jit(jax_make(jm, jfl, flops_per_client_round=1e9))
    jms = []
    for b in batches(jfl.num_clients, ROUNDS):
        js, m = jr(js, {k: jax.numpy.asarray(v) for k, v in b.items()})
        jms.append(jax.tree.map(np.asarray, m))
    return jax.tree.map(np.asarray, js0), js, jms


def run_tp_case(world, arch, gates, pallas, split):
    """JAX single-device, the port's single-process round and the
    tensor-parallel round on ``split`` (client, zero, tp, sp) from the
    same JAX state over ``ROUNDS`` batches."""
    tm = build_model(torch_cfg(arch))
    js0, js, jms = jax_round(arch, gates)
    over = dict(GATES[gates], use_pallas_agg=pallas)
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
    spec = dict(arch=arch, fl=dict(BASE, **over), state=ts0, batches=bs, calls=rec.calls,
                split=split)
    return js, jms, ts, tms, world.run(rank_tp_round, spec)


def hold_tp(js, jms, ts, tms, ranks, tol, split):
    """Rank 0's gathered state and metrics against JAX and the
    single-process round; every rank's gathered state equal to rank 0's;
    each round's ledger: the delta all-reduce across the client ranks
    (one, none when they are one rank), the zero axis's gradient
    all-reduces (one a local step of each of the rank's slots), the
    tensor-axis collectives (none spanning two client coordinates:
    asserted on the rank)."""
    client, zero, t, s = split
    r0 = ranks[0]
    hold_metrics(jms, r0["metrics"])
    hold_state(js, r0["state"], tol)
    hold_metrics([{k: v.numpy() for k, v in m.items()} for m in tms], r0["metrics"])
    host = jax.tree.map(lambda x: x.numpy(), [ts.params, ts.server_mu])
    hold_leaves(host[0], r0["state"].params, tol)
    if ts.server_mu is not None:
        hold_leaves(host[1], r0["state"].server_mu, tol, what="server_mu")
    for r in ranks[1:]:  # the whole state is the same on every rank
        for a, b in zip(tree.leaves([r0["state"].params, r0["state"].server_mu]),
                        tree.leaves([r["state"].params, r["state"].server_mu])):
            assert (a is None and b is None) or torch.equal(a, b)
        assert r["metrics"] == r0["metrics"]
    slots = BASE["slots"] // client
    for r in ranks:
        assert r["contract"] == [1 if client > 1 else 0] * ROUNDS
        assert r["zero_ops"] == [(BASE["local_steps"] * slots) if zero > 1 else 0] * ROUNDS
        assert all(c["count"] > 0 for c in r["tensor"])
    assert all(m["slot_participation"] > 0 for m in r0["metrics"])


def hold_blocks(arch, ranks, split):
    """Each rank holds its block of every leaf the rule table splits: the
    heads over tp (kv where they divide), head_dim over sp, mlp and vocab
    over tp × sp; the momentum shaped like the parameters."""
    cfg = torch_cfg(arch)
    _, _, t, s = split
    hkv = cfg.num_kv_heads // t if cfg.num_kv_heads % t == 0 else cfg.num_kv_heads
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim // s
    want = {
        "embed": (cfg.padded_vocab // (t * s), d),
        "layers/wq": (L, d, cfg.num_heads // t, hd),
        "layers/wk": (L, d, hkv, hd),
        "layers/wo": (L, cfg.num_heads // t, hd, d),
        "layers/w_down": (L, cfg.d_ff // (t * s), d),
        "layers/attn_norm": (L, d),
    }
    for r in ranks:
        got = r["local_shapes"]
        assert {k: got[k] for k in want} == want
        assert r["mu_shapes"] is None or r["mu_shapes"] == list(got.values())
