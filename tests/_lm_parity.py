"""The port's LM round (``repro_torch.fl.round``) against the JAX
package's (``repro.fl.round``), from one state on the same batches, on
the JAX package's draws (``_jax_draws.JaxDraws`` given the FL state's
initial key replays the round's key chain).

``check_rounds(over, attack)`` builds the reduced llama3.2-1b in float32
and ``FLConfig(num_clients=16, slots=4, local_steps=2, **over)`` in both
packages, starts the port from the JAX ``init_fl_state`` through
``convert.fl_state_from_jax``, runs the jitted JAX round and the port's
round three times on batches made from a numpy seed, and holds:

  * every integer metric (selected and participating slots, cold starts,
    fault counters) exactly;
  * every float metric (loss, latency, energy, mean utility, mean drift)
    to ``rtol=1e-4, atol=1e-5`` (float32; the loss goes through the
    model's forward, the rest through the scheduler);
  * the final parameters and server momentum to ``tol`` (default
    ``MODEL_TOL``, ``tests/test_torch_models.py``: XLA and ATen order the
    sums of the forward and backward differently, a few ulps per layer);
  * the scheduler state: integer and boolean rows exactly, float rows to
    ``rtol=1e-5, atol=1e-7``;
  * ``rng``, ``step`` and ``server_count`` exactly.

``loose`` names a float fraction: then at most that share of each
parameter leaf's elements may exceed ``tol``, and all must hold ``cap``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _jax_draws import JaxDraws
from _threads import one_thread  # noqa: F401 (re-exported: autouse in importers)

from repro.configs import get_reduced as jax_reduced
from repro.core.scheduler import SchedulerConfig as JaxSched
from repro.fl import FLConfig as JaxFL
from repro.fl import init_fl_state as jax_init
from repro.fl import make_round_fn as jax_make
from repro.fl.round import AttackConfig as JaxAttack
from repro.models import build_model as jax_build
from repro_torch import convert, tree
from repro_torch.configs import get_reduced
from repro_torch.core.scheduler import SchedulerConfig
from repro_torch.fl import FLConfig, make_round_fn
from repro_torch.fl.round import AttackConfig
from repro_torch.models import build_model

F32 = dict(param_dtype="float32", compute_dtype="float32")
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
BASE = dict(num_clients=16, slots=4, local_steps=2)
INT_METRICS = ("num_selected", "slot_participation", "cold_starts")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def configs(over: dict):
    """(JAX FLConfig, port FLConfig) of ``BASE`` + ``over``; ``faults`` may
    be a dict of ``FaultConfig`` fields. θ_d = 0.5 lets the random
    histograms of ``batches`` pass the drift gate."""
    kw = dict(BASE, **over)
    out = []
    for fl_cls, sched_cls, faults_mod in ((JaxFL, JaxSched, "repro.sim.faults"),
                                          (FLConfig, SchedulerConfig,
                                           "repro_torch.sim.faults")):
        k = dict(kw)
        if "faults" in k:
            k["faults"] = importlib.import_module(faults_mod).FaultConfig(**k["faults"])
        k.setdefault("scheduler", sched_cls(theta_d=0.5))
        out.append(fl_cls(**k))
    return out


def batches(n: int, rounds: int, seed: int = 0, slots: int = 4, seq: int = 33,
            per_slot: int = 4, vocab: int = 256):
    """``rounds`` numpy batches of the round's layout."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        out.append({
            "tokens": rng.integers(0, vocab, (slots * per_slot, seq)).astype(np.int32),
            "slot_data_sizes": rng.uniform(50, 300, slots).astype(np.float32),
            "telemetry_cpu": rng.uniform(0.4, 1.0, n).astype(np.float32),
            "telemetry_mem": rng.uniform(0.4, 1.0, n).astype(np.float32),
            "telemetry_batt": rng.uniform(0.3, 1.0, n).astype(np.float32),
            "telemetry_energy": rng.uniform(0.4, 1.0, n).astype(np.float32),
            "hist": (np.abs(rng.standard_normal((n, 64))) + 1.0).astype(np.float32),
        })
    return out


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def run_both(jm, tm, jfl, tfl, bs, attack=None, key=0, flops=1e9, each=None):
    """Run both rounds over the batches ``bs`` from one state. Returns
    (JAX state, JAX metrics list, port state, port metrics list). With
    ``each``, ``each(js, ts)`` is called after every round and the port
    restarts the next round from the JAX state (``fl_state_from_jax``)."""
    attack = attack or {}
    js = jax_init(jm, jfl, jax.random.PRNGKey(key))
    js_np = jax.tree.map(np.asarray, js)
    ts = convert.fl_state_from_jax(tm.cfg, js_np, device="cpu")
    jr = jax.jit(jax_make(jm, jfl, attack=JaxAttack(**attack), flops_per_client_round=flops))
    tr = make_round_fn(tm, tfl, attack=AttackConfig(**attack), flops_per_client_round=flops,
                       draws=JaxDraws(0, fl_rng=js_np.rng))
    jms, tms = [], []
    for b in bs:
        js, m = jr(js, to_jax(b))
        jms.append(jax.tree.map(np.asarray, m))
        with torch.no_grad():
            ts, m = tr(ts, to_torch(b))
        tms.append(m)
        if each is not None:
            each(js, ts)
            ts = convert.fl_state_from_jax(tm.cfg, jax.tree.map(np.asarray, js),
                                           device="cpu")
    return js, jms, ts, tms


def hold_metrics(jms, tms):
    for r, (mj, mt) in enumerate(zip(jms, tms)):
        assert set(mt) == set(mj), (set(mt) ^ set(mj))
        for k in mj:
            if k in INT_METRICS or k.startswith(("fault_", "fog_", "round_skipped")):
                assert int(mt[k]) == int(mj[k]), (r, k, int(mt[k]), int(mj[k]))
            else:
                np.testing.assert_allclose(_np(mt[k]), mj[k], err_msg=f"round {r} {k}",
                                           **METRIC_TOL)


def hold_leaves(jtree, ttree, tol, loose=None, what="params", cap=None):
    jl, paths = jax.tree.leaves(jtree), jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = tree.leaves(ttree)
    assert len(jl) == len(tl)
    for (path, a), b in zip(paths, tl):
        a, b = np.asarray(a, np.float32), _np(b.float())
        name = f"{what}{jax.tree_util.keystr(path)}"
        if loose is None:
            np.testing.assert_allclose(b, a, err_msg=name, **tol)
        else:
            bad = np.abs(b - a) > tol["atol"] + tol["rtol"] * np.abs(a)
            assert bad.mean() <= loose, (name, int(bad.sum()), bad.size)
            if cap is not None:
                np.testing.assert_allclose(b, a, err_msg=name, **cap)


def hold_state(js, ts, tol=MODEL_TOL, loose=None, cap=None):
    hold_leaves(js.params, ts.params, tol, loose, cap=cap)
    if js.server_mu is None:
        assert ts.server_mu is None
    else:
        hold_leaves(js.server_mu, ts.server_mu, tol, loose, "server_mu", cap)
    for name in ("warm", "last_used", "round_index"):
        np.testing.assert_array_equal(_np(getattr(ts.sched, name)),
                                      np.asarray(getattr(js.sched, name)), err_msg=name)
    for name in ("prev_hist", "theta_e", "energy_spent"):
        np.testing.assert_allclose(_np(getattr(ts.sched, name)),
                                   np.asarray(getattr(js.sched, name)), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(ts.rng, np.asarray(js.rng))
    assert ts.step == int(js.step)
    assert int(ts.server_count) == int(js.server_count)


def check_rounds(over=None, attack=None, rounds=3, tol=MODEL_TOL, loose=None,
                 cap=None, resync=False):
    """``resync``: hold the state after every round and start the port's
    next round from the JAX state, so each round is held on its own."""
    over = over or {}
    jfl, tfl = configs(over)
    jm = jax_build(jax_reduced("llama3.2-1b", **F32))
    tm = build_model(get_reduced("llama3.2-1b", **F32))
    each = (lambda js, ts: hold_state(js, ts, tol, loose, cap)) if resync else None
    js, jms, ts, tms = run_both(jm, tm, jfl, tfl, batches(tfl.num_clients, rounds),
                                attack, each=each)
    hold_metrics(jms, tms)
    if not resync:
        hold_state(js, ts, tol, loose, cap)
    return jms, tms
