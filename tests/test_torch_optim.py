"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX package's, several steps on random trees from a numpy seed, and the
host key helpers (``repro_torch.random.prng_key`` / ``split_key``)
against ``jax.random``.

Tolerances: float32 arithmetic with the same operation order, so
``rtol=1e-6, atol=1e-7`` for SGD(M); AdamW divides by sqrt(v) and raises
b1 / b2 to the count, which XLA and ATen round a few ulps apart:
``rtol=1e-5, atol=1e-7``. Schedules to ``rtol=1e-6``. Keys exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro import optim as jopt
from repro_torch import optim as topt
from repro_torch import tree
from repro_torch.random import prng_key, split_key

SGD_TOL = dict(rtol=1e-6, atol=1e-7)
ADAM_TOL = dict(rtol=1e-5, atol=1e-7)


def _trees(rng, dtype=np.float32):
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 3, 2)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(dtype)

    return make(shapes)


def _both(t):
    return (jax.tree.map(jnp.asarray, t),
            tree.map(lambda x: torch.from_numpy(x.copy()), t))


def _close(jt, tt, tol):
    for a, b in zip(jax.tree.leaves(jt), tree.leaves(tt)):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32), **tol)


def _run(jopt_pair, topt_pair, steps, tol, seed=0):
    rng = np.random.default_rng(seed)
    jp, tp = _both(_trees(rng))
    (ji, ju), (ti, tu) = jopt_pair, topt_pair
    js, ts = ji(jp), ti(tp)
    for _ in range(steps):
        jg, tg = _both(_trees(rng))
        jup, js = ju(jg, js, jp)
        tup, ts = tu(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, jup), topt.apply_updates(tp, tup)
        _close(jup, tup, tol)
    _close(jp, tp, tol)
    _close(js.mu, ts.mu, tol)
    if js.nu is not None:
        _close(js.nu, ts.nu, tol)
    assert int(ts.count) == int(js.count) == steps
    assert ts.count.dtype == torch.int32


@pytest.mark.parametrize("nesterov", [True, False], ids=["nesterov", "plain"])
def test_sgdm_matches_jax(nesterov):
    _run(jopt.sgdm(0.05, 0.9, nesterov), topt.sgdm(0.05, 0.9, nesterov), 5, SGD_TOL)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01], ids=["no-decay", "decay"])
def test_adamw_with_schedule_matches_jax(weight_decay):
    js = jopt.linear_warmup_cosine(1e-2, warmup_steps=2, decay_steps=6)
    ts = topt.linear_warmup_cosine(1e-2, warmup_steps=2, decay_steps=6)
    _run(jopt.adamw(js, weight_decay=weight_decay),
         topt.adamw(ts, weight_decay=weight_decay), 6, ADAM_TOL)


def test_adamw_constant_lr_matches_jax():
    _run(jopt.adamw(3e-3), topt.adamw(3e-3), 4, ADAM_TOL, seed=1)


def test_bf16_parameters_keep_their_dtype():
    """bf16 parameters, float32 moments; the update rounds once to bf16."""
    rng = np.random.default_rng(2)
    p = {"w": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)).bfloat16()}
    init, update = topt.sgdm(0.1)
    st = init(p)
    assert st.mu["w"].dtype == torch.float32 and st.nu is None
    g = {"w": torch.ones((4, 8), dtype=torch.bfloat16)}
    up, st = update(g, st, p)
    new = topt.apply_updates(p, up)
    assert new["w"].dtype == torch.bfloat16
    want = (p["w"].float() + up["w"]).bfloat16()
    assert torch.equal(new["w"], want)


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)),
    ("cosine_decay", (0.3, 10, 0.2)),
    ("linear_warmup_cosine", (0.3, 3, 12, 0.1)),
])
def test_schedules_match_jax(name, args):
    jf, tf = getattr(jopt, name)(*args), getattr(topt, name)(*args)
    for c in range(15):
        got = tf(torch.tensor(c, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(jf(jnp.asarray(c, jnp.int32))),
                                   rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 3, -5])
def test_host_keys_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng_key(seed), np.asarray(key))
    for n in (1, 2, 5):
        np.testing.assert_array_equal(split_key(prng_key(seed), n),
                                      np.asarray(jax.random.split(key, n)))
    # a chain of round splits, as the FL state's rng advances
    k_np, k_j = prng_key(seed), key
    for _ in range(4):
        k_np, k_j = split_key(k_np, 5)[0], jax.random.split(k_j, 5)[0]
    np.testing.assert_array_equal(k_np, np.asarray(k_j))
