"""The port's checkpoints (``repro_torch.checkpoint``): the JAX package's
on-disk format, so a checkpoint written by either package restores in
the other; atomic saves, the newest complete step, the background
writer's garbage collection, and a restored state's next round equal to
the uninterrupted state's, bit for bit. Every comparison is exact: a
checkpoint stores each leaf's bits (bf16 as uint16)."""
import os

import jax
import numpy as np
import torch
from _lm_parity import batches, to_torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro import checkpoint as jckpt
from repro.configs import get_reduced as jax_reduced
from repro.fl import FLConfig as JaxFL
from repro.fl import init_fl_state as jax_init
from repro.models import build_model as jax_build
from repro_torch import checkpoint as ckpt
from repro_torch import convert, tree
from repro_torch.configs import get_reduced
from repro_torch.fl import FLConfig, init_fl_state, make_round_fn
from repro_torch.fl.state import FLState
from repro_torch.models import build_model

FL = dict(num_clients=16, slots=4, local_steps=2)


def _port_state(seed=0, **over):
    model = build_model(get_reduced("llama3.2-1b"))
    return model, init_fl_state(model, FLConfig(**FL, **over), seed, device="cpu")


def _jax_state():
    jm = jax_build(jax_reduced("llama3.2-1b"))
    return jax_init(jm, JaxFL(**FL), jax.random.PRNGKey(7))


def _equal_port(a: FLState, b: FLState):
    for x, y in zip(tree.leaves([a.params, a.server_mu]), tree.leaves([b.params, b.server_mu])):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for f in ("prev_hist", "theta_e", "warm", "last_used", "energy_spent", "round_index"):
        x, y = getattr(a.sched, f), getattr(b.sched, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    assert torch.equal(a.server_count, b.server_count)
    np.testing.assert_array_equal(a.rng, b.rng)
    assert a.rng.dtype == np.uint32 and a.step == b.step and isinstance(b.step, int)


def test_round_trip_keeps_every_bit(tmp_path):
    model, st = _port_state()
    assert st.params["embed"].dtype == torch.bfloat16
    st = FLState(params=st.params, server_mu=st.server_mu,
                 server_count=torch.tensor(4, dtype=torch.int32), sched=st.sched,
                 rng=st.rng, step=4)
    path = ckpt.save(str(tmp_path), 4, st)
    assert os.path.basename(path) == "step_00000004"
    assert sorted(os.listdir(path)) == ["manifest.json", "shard_0.npz"]
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        assert "0/embed::bf16" in data and data["0/embed::bf16"].dtype == np.uint16
        assert data["4"].dtype == np.uint32 and int(data["5"]) == 4
    _, like = _port_state(seed=1)
    _equal_port(ckpt.restore(str(tmp_path), 4, like), st)


def test_latest_step_ignores_incomplete(tmp_path):
    _, st = _port_state()
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    ckpt.save(str(tmp_path), 2, st)
    os.makedirs(tmp_path / "step_00000009")  # a crash before its manifest
    os.makedirs(tmp_path / "step_00000011.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_async_checkpointer_keeps_the_newest(tmp_path):
    _, st = _port_state()
    c = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        c.save(s, st)
    c.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    js = _jax_state()
    jckpt.save(str(tmp_path), 3, js)
    tcfg = get_reduced("llama3.2-1b")
    _, like = _port_state(seed=3)
    got = ckpt.restore(str(tmp_path), 3, like)
    _equal_port(got, convert.fl_state_from_jax(tcfg, jax.tree.map(np.asarray, js),
                                               device="cpu"))


def test_port_checkpoint_restores_into_jax(tmp_path):
    model, st = _port_state(seed=2)
    ckpt.save(str(tmp_path), 5, st)
    like = _jax_state()
    got = jckpt.restore(str(tmp_path), 5, like)
    jl = jax.tree.leaves(got)
    tl = tree.leaves([st.params, st.server_mu]) + [
        st.server_count, *(getattr(st.sched, f) for f in
                           ("prev_hist", "theta_e", "warm", "last_used", "energy_spent",
                            "round_index"))]
    for a, b in zip(jl, tl):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())
    np.testing.assert_array_equal(np.asarray(got.rng), st.rng)
    assert int(got.step) == st.step and got.step.dtype == np.int32


def test_restored_state_continues_bitwise(tmp_path):
    """A state saved after one round and restored runs its next round
    exactly as the uninterrupted state does (kernel path, momentum)."""
    model = build_model(get_reduced("llama3.2-1b"))
    fl = FLConfig(**FL, use_pallas_agg=True)
    round_fn = make_round_fn(model, fl, flops_per_client_round=1e9)
    bs = batches(16, 2, seed=4)
    st = init_fl_state(model, fl, 0, device="cpu")
    with torch.no_grad():
        st, _ = round_fn(st, to_torch(bs[0]))
    ckpt.save(str(tmp_path), st.step, st)
    _, like = _port_state(seed=9, use_pallas_agg=True)
    restored = ckpt.restore(str(tmp_path), ckpt.latest_step(str(tmp_path)), like)
    with torch.no_grad():
        a, ma = round_fn(st, to_torch(bs[1]))
        b, mb = round_fn(restored, to_torch(bs[1]))
    _equal_port(a, b)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
