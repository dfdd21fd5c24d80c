"""The port's event queue, staleness weighting and churn against the JAX
package's (``repro/sim/events``), on the same inputs made with numpy.

The queue cases are those of ``tests/test_async_engine.py``: time-ordered
pops, random interleaved push / pop against ``heapq``, overflow, batch
pops against successive single pops (ties included), and cancellation
before a drain. Every queue the port builds is compared field by field
with the JAX queue built from the same calls, so slot assignment is held
too, not only the pop order. Staleness and churn are compared at float32
rounding; churn takes the JAX package's own uniforms through a provider.
"""
import heapq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _async_parity import one_thread  # noqa: F401 (autouse)

from repro.core.aggregation import fedavg_stacked as jax_fedavg
from repro.sim.events import churn as jchurn
from repro.sim.events import queue as jq
from repro.sim.events import staleness as jst
from repro_torch.core.aggregation import fedavg_stacked
from repro_torch.sim.events import (
    KIND_COMPLETE,
    ChurnConfig,
    async_aggregate,
    available_mask,
    cancel_events,
    init_online,
    make_queue,
    pop_batch,
    pop_event,
    pop_order_rank,
    push_event,
    push_events,
    stale_discount,
    staleness_weights,
    step_churn,
)

CAP = 32
FIELDS = ("time", "client", "kind", "payload", "valid", "dropped")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_queue(tq, jqq):
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(tq, f)), np.asarray(getattr(jqq, f)),
                                      err_msg=f)


def _batch(times, clients, kinds, mask):
    """The same batch push on both queues (an empty queue of CAP slots)."""
    n = len(times)
    t = make_queue(CAP)
    t = push_events(t, torch.from_numpy(times), torch.from_numpy(clients),
                    torch.from_numpy(kinds), torch.zeros(n), torch.from_numpy(mask))
    j = _jax_batch(jnp.asarray(times), jnp.asarray(clients), jnp.asarray(kinds),
                   jnp.asarray(mask))
    assert_same_queue(t, j)
    return t, j


@jax.jit
def _jax_batch(times, clients, kinds, mask):
    q = jq.make_queue(CAP)
    return jq.push_events(q, times, clients, kinds, jnp.zeros(times.shape), mask)


@jax.jit
def _jax_drain(q):
    def body(q, _):
        ev, q = jq.pop_event(q)
        return q, (ev.time, ev.client, ev.kind, ev.valid)

    return jax.lax.scan(body, q, None, length=CAP)[1]


def _drain(q):
    out = []
    for _ in range(CAP):
        ev, q = pop_event(q)
        out.append((float(ev.time), int(ev.client), int(ev.kind), bool(ev.valid)))
    return [np.asarray(x) for x in zip(*out)]


def test_queue_pops_sorted_like_jax():
    """24 random times pushed at once pop in time order, the clients riding
    along, exactly as from the JAX queue."""
    rng = np.random.RandomState(0)
    times = rng.uniform(0, 100, size=24).astype(np.float32)
    t, j = _batch(times, np.arange(24, dtype=np.int32), np.zeros(24, np.int32),
                  np.ones(24, bool))
    tt, tc, tk, tv = _drain(t)
    jt, jc, jk, jv = (np.asarray(x) for x in _jax_drain(j))
    assert tv[:24].all() and not tv[24:].any()
    np.testing.assert_array_equal(tt[:24], jt[:24])
    np.testing.assert_array_equal(tc[:24], jc[:24])
    np.testing.assert_array_equal(tc[:24], np.argsort(times, kind="stable"))
    np.testing.assert_array_equal(tv, jv)


def test_queue_random_interleaved_push_pop_matches_heapq_and_jax():
    push_j, pop_j = jax.jit(jq.push_event), jax.jit(jq.pop_event)
    rng = np.random.RandomState(1)
    t, j, heap, counter = make_queue(64), jq.make_queue(64), [], 0
    for _ in range(200):
        if heap and rng.rand() < 0.45:
            ev, t = pop_event(t)
            jev, j = pop_j(j)
            t_ref, _, c_ref = heapq.heappop(heap)
            assert bool(ev.valid)
            assert float(ev.time) == float(jev.time) == np.float32(t_ref)
            assert int(ev.client) == int(jev.client) == c_ref
        else:
            x = float(np.float32(rng.uniform(0, 1000)))
            t = push_event(t, x, counter, 0, 0.0, True)
            j = push_j(j, x, counter, 0, 0.0, True)
            heapq.heappush(heap, (x, counter, counter))  # FIFO among ties
            counter += 1
        assert_same_queue(t, j)
    while heap:
        ev, t = pop_event(t)
        assert float(ev.time) == heapq.heappop(heap)[0]
    ev, _ = pop_event(t)
    assert not bool(ev.valid)


@pytest.mark.parametrize("enable", [True, False, "tensor"])
def test_push_event_enable_and_overflow_like_jax(enable):
    """A full queue drops and counts; ``enable`` False (a bool or a ()
    tensor) pushes nothing."""
    gate = torch.tensor(False) if enable == "tensor" else enable
    t, j = make_queue(4), jq.make_queue(4)
    for i in range(6):
        on = gate if i % 2 else True
        t = push_event(t, float(i), i, 0, 0.0, on)
        j = jq.push_event(j, float(i), i, 0, 0.0, (enable is True) if i % 2 else True)
        assert_same_queue(t, j)
    assert int(t.dropped) == (2 if enable is True else 0)


def test_push_events_overflow_and_mask_like_jax():
    """A batch larger than the free slots fills them in candidate order and
    counts the rest; masked-out candidates take no slot."""
    rng = np.random.RandomState(3)
    t, j = make_queue(8), jq.make_queue(8)
    for step in range(3):
        times = rng.uniform(0, 10, 6).astype(np.float32)
        mask = rng.rand(6) < 0.8
        args = (times, np.arange(6, dtype=np.int32) + 10 * step,
                np.full(6, step, np.int32), times * 2, mask)
        t = push_events(t, *(torch.from_numpy(a) for a in args))
        j = jq.push_events(j, *(jnp.asarray(a) for a in args))
        assert_same_queue(t, j)
        ev, t = pop_event(t)
        _, j = jq.pop_event(j)
    assert int(t.dropped) > 0


@pytest.mark.parametrize("take", (1, 3, 7, 20, 25))
def test_pop_batch_matches_sequential_pops_and_jax(take):
    """``pop_batch(q, take)`` frees exactly the slots ``take`` successive
    pops would, duplicate-time ties included, and reports the last popped
    time; its slots, its queue and ``pop_order_rank`` equal the JAX ones."""
    rng = np.random.RandomState(7)
    times = rng.choice([1.0, 2.0, 2.0, 3.0, 5.0, 5.0, 5.0, 8.0], 20).astype(np.float32)
    q, j = _batch(times, np.arange(20, dtype=np.int32), np.zeros(20, np.int32),
                  np.ones(20, bool))
    np.testing.assert_array_equal(_np(pop_order_rank(q)), np.asarray(jq.pop_order_rank(j)))
    popped, t_last, q2 = pop_batch(q, take)
    jpopped, jt_last, j2 = jq.pop_batch(j, take)
    np.testing.assert_array_equal(_np(popped), np.asarray(jpopped))
    assert float(t_last) == float(jt_last)
    assert_same_queue(q2, j2)
    qs, last = q, None
    for _ in range(min(take, 20)):
        ev, qs = pop_event(qs)
        last = float(ev.time)
    np.testing.assert_array_equal(_np(q2.valid), _np(qs.valid))
    np.testing.assert_array_equal(_np(popped), _np(q.valid) & ~_np(qs.valid))
    assert float(t_last) == last
    # a tensor count, as the coalesced engine passes it, frees the same
    assert torch.equal(pop_batch(q, torch.tensor(take))[0], popped)


def test_pop_batch_of_nothing():
    q = push_event(make_queue(4), 1.0, 0, 0)
    popped, t_last, q2 = pop_batch(q, 0)
    assert not popped.any() and float(t_last) == float("-inf")
    assert torch.equal(q2.valid, q.valid)


def test_queue_cancel_events():
    args = (np.arange(4.0, dtype=np.float32), np.arange(4, dtype=np.int32),
            np.full(4, KIND_COMPLETE, np.int32), np.ones(4, bool))
    q, j = _batch(*args)
    kill = np.asarray([False, True, False, True])
    q = cancel_events(q, torch.from_numpy(kill), KIND_COMPLETE)
    assert_same_queue(q, jq.cancel_events(j, jnp.asarray(kill), KIND_COMPLETE))
    ev0, q = pop_event(q)
    ev1, q = pop_event(q)
    ev2, _ = pop_event(q)
    assert (int(ev0.client), int(ev1.client)) == (0, 2)
    assert not bool(ev2.valid)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("kill_kind", (0, 1))
def test_cancel_then_pop_matches_heapq_and_jax(seed, kill_kind):
    """A batch push, a cancellation and a drain: no cancelled (client,
    kind) event pops, the survivors pop in the heap oracle's order, and
    every queue equals the JAX one. Batches are padded to 24 candidates
    (the pad masked out) so that one JAX program serves every seed."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 25))
    times = rng.uniform(0, 100, n).astype(np.float32)
    clients = rng.randint(0, 8, n).astype(np.int32)
    kinds = rng.randint(0, 2, n).astype(np.int32)
    kill = rng.rand(8) < 0.4
    pad = lambda a: np.concatenate([a, np.zeros(24 - n, a.dtype)])  # noqa: E731
    q, j = _batch(pad(times), pad(clients), pad(kinds), np.arange(24) < n)
    q = cancel_events(q, torch.from_numpy(kill), kill_kind)
    j = jq.cancel_events(j, jnp.asarray(kill), kill_kind)
    assert_same_queue(q, j)
    t, c, k, v = _drain(q)
    for a, b in zip((t, c, k, v), _jax_drain(j)):
        np.testing.assert_array_equal(a, np.asarray(b))
    cancelled = kill[clients] & (kinds == kill_kind)
    heap = [(times[i], i, clients[i], kinds[i]) for i in range(n) if not cancelled[i]]
    heapq.heapify(heap)
    n_live = len(heap)
    assert int(v.sum()) == n_live
    for i in range(n_live):
        t_ref, _, c_ref, k_ref = heapq.heappop(heap)
        assert not (kill[c[i]] and k[i] == kill_kind)
        assert (t[i], c[i], k[i]) == (t_ref, c_ref, k_ref)


# --------------------------------------------------------------------- #
# staleness weighting
# --------------------------------------------------------------------- #
def _weights_case(seed, n=12):
    rng = np.random.RandomState(seed)
    mask = rng.rand(n) < 0.7
    sizes = rng.uniform(1.0, 500.0, n).astype(np.float32)
    stal = rng.randint(0, 10, n).astype(np.float32)
    return mask, sizes, stal


@pytest.mark.parametrize("exponent", (0.0, 0.5, 1.0, 2.75))
def test_stale_discount_like_jax(exponent):
    s = np.asarray([-3.0, 0.0, 0.5, 1.0, 7.0, 123.0, 1e4], np.float32)
    ours = stale_discount(torch.from_numpy(s), exponent)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jst.stale_discount(jnp.asarray(s),
                                                                           exponent)),
                               rtol=1e-6)
    assert float(stale_discount(torch.zeros(()), exponent)) == 1.0
    assert (ours.numpy() > 0).all() and (np.diff(ours.numpy()) <= 0).all()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("exponent", (0.0, 0.5, 3.0))
def test_staleness_weights_like_jax(seed, exponent):
    mask, sizes, stal = _weights_case(seed)
    w, scale = staleness_weights(torch.from_numpy(mask), torch.from_numpy(sizes),
                                 torch.from_numpy(stal), exponent)
    jw, jscale = jst.staleness_weights(jnp.asarray(mask), jnp.asarray(sizes),
                                       jnp.asarray(stal), exponent)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-5)
    assert (w.numpy()[~mask] == 0).all() and 0.0 < float(scale) <= 1.0 + 1e-6
    if mask.any():
        np.testing.assert_allclose(float(w.sum()), 1.0, rtol=1e-4)
        # raising one client's staleness cannot raise its weight
        i = int(np.flatnonzero(mask)[0])
        st2 = stal.copy()
        st2[i] += 5.0
        w2, _ = staleness_weights(torch.from_numpy(mask), torch.from_numpy(sizes),
                                  torch.from_numpy(st2), exponent)
        assert float(w2[i]) <= float(w[i]) + 1e-6


def _updates(rng, n):
    return [{"w": rng.randn(n, 6, 4).astype(np.float32),
             "b": rng.randn(n, 4).astype(np.float32)}]


@pytest.mark.parametrize("exponent", (0.0, 0.5))
def test_async_aggregate_like_jax(exponent):
    rng = np.random.RandomState(0)
    n = 10
    upd = _updates(rng, n)
    mask = rng.rand(n) < 0.7
    sizes = rng.uniform(1.0, 300.0, n).astype(np.float32)
    stal = rng.randint(0, 9, n).astype(np.float32)
    ours = async_aggregate([{k: torch.from_numpy(v) for k, v in upd[0].items()}],
                           torch.from_numpy(mask), torch.from_numpy(sizes),
                           torch.from_numpy(stal), exponent)
    ref = jst.async_aggregate(jax.tree.map(jnp.asarray, upd), jnp.asarray(mask),
                              jnp.asarray(sizes), jnp.asarray(stal), exponent)
    for k in ("w", "b"):
        np.testing.assert_allclose(ours[0][k].numpy(), np.asarray(ref[0][k]),
                                   rtol=1e-5, atol=1e-7)


def test_zero_staleness_full_buffer_is_exactly_fedavg():
    """Zero staleness, or exponent 0 with staleness: the async rule IS
    Eq. 6, bit for bit, in the port as in the JAX package."""
    rng = np.random.RandomState(0)
    n = 10
    upd = [{k: torch.from_numpy(v) for k, v in _updates(rng, n)[0].items()}]
    mask = torch.ones(n, dtype=torch.bool)
    sizes = torch.from_numpy(rng.uniform(1.0, 300.0, n).astype(np.float32))
    ref = fedavg_stacked(upd, mask, sizes)
    stal = torch.from_numpy(rng.randint(0, 9, n).astype(np.float32))
    for s, a in ((torch.zeros(n), 0.5), (stal, 0.0)):
        out = async_aggregate(upd, mask, sizes, s, a)
        for k in ("w", "b"):
            assert torch.equal(out[0][k], ref[0][k])
    jref = jax_fedavg(jax.tree.map(lambda t: jnp.asarray(t.numpy()), upd),
                      jnp.asarray(mask.numpy()), jnp.asarray(sizes.numpy()))
    np.testing.assert_allclose(ref[0]["w"].numpy(), np.asarray(jref[0]["w"]), rtol=1e-5,
                               atol=1e-7)  # summation order


@pytest.mark.parametrize("s,a", ((0.0, 0.5), (3.0, 0.5), (7.0, 1.0)))
def test_fedasync_single_update_steps_by_discounted_delta(s, a):
    n = 6
    delta = torch.zeros((n, 3))
    delta[2] = torch.tensor([1.0, -2.0, 3.0])
    mask = torch.zeros(n, dtype=torch.bool)
    mask[2] = True
    out = async_aggregate(delta, mask, torch.full((n,), 100.0), torch.full((n,), s), a)
    ref = jst.async_aggregate(jnp.asarray(delta.numpy()), jnp.asarray(mask.numpy()),
                              jnp.full((n,), 100.0), jnp.full((n,), s), a)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(), (1 + s) ** -a * np.asarray([1.0, -2.0, 3.0]),
                               rtol=1e-4)


# --------------------------------------------------------------------- #
# churn & availability
# --------------------------------------------------------------------- #
class _KeyDraws:
    """A provider handing the port the JAX package's uniforms of one key."""

    device = torch.device("cpu")

    def __init__(self, key):
        self.key = key

    def uniform(self, site, shape, lo, hi, **ctx):
        return torch.from_numpy(np.asarray(jax.random.uniform(self.key, shape)))


def test_churn_zero_rates_is_identity():
    online = torch.tensor([True, False, True, True])
    out = step_churn(ChurnConfig(), online, torch.tensor(1e5), None, round=0)
    assert out is online


@pytest.mark.parametrize("cfg,start,dt", [
    (ChurnConfig(departure_rate=5.0), True, 10_000.0),
    (ChurnConfig(arrival_rate=5.0), False, 10_000.0),
    (ChurnConfig(arrival_rate=0.2, departure_rate=0.8), "mixed", 300.0),
    (ChurnConfig(arrival_rate=0.2, departure_rate=0.8), "mixed", -5.0),
], ids=["depart", "arrive", "both", "negative-dt"])
def test_step_churn_like_jax(cfg, start, dt):
    """The same uniforms give the same presence as the JAX package's, and
    heavy rates over a long interval move most of the population."""
    n = 512
    key = jax.random.PRNGKey(0)
    if start == "mixed":
        online = np.random.RandomState(1).rand(n) < 0.5
    else:
        online = np.full(n, start)
    ours = step_churn(cfg, torch.from_numpy(online), torch.tensor(dt, dtype=torch.float32),
                      _KeyDraws(key), round=3)
    ref = jchurn.step_churn(cfg, jnp.asarray(online), jnp.float32(dt), key)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    if start is True:
        assert int(ours.sum()) < n // 4
    elif start is False:
        assert int(ours.sum()) > 3 * n // 4


@pytest.mark.parametrize("frac", (1.0, 0.3))
def test_init_online_like_jax(frac):
    key = jax.random.PRNGKey(5)
    cfg = ChurnConfig(initial_online_frac=frac)
    ours = init_online(cfg, 64, _KeyDraws(key))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jchurn.init_online(cfg, 64, key)))


def test_available_mask_battery_death():
    cfg = ChurnConfig(death_batt=0.1)
    online = torch.tensor([True, True, False])
    batt = torch.tensor([0.5, 0.05, 0.9])
    ours = available_mask(cfg, online, batt)
    assert ours.tolist() == [True, False, False]
    ref = jchurn.available_mask(cfg, jnp.asarray(online.numpy()), jnp.asarray(batt.numpy()))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
