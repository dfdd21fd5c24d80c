"""The port's selective scan (``repro_torch.models.ssm.selective_scan`` and
``selective_scan_step``, hymba's SSM heads) against the JAX package's
(``repro.models.ssm``), on inputs made from a numpy seed, in float32.

Both run the same float32 recurrence; the JAX package scans it in
checkpointed chunks of 128 steps, the port step by step, so the two
differ only in XLA's and ATen's order of the state's sums: held to
``rtol=1e-5, atol=1e-6``.

T = 200 crosses the JAX scan's 128-step chunk: the JAX package pads the
sequence to 256 steps with zeros, and a zero step size leaves the state
as it was (``exp(0) · s + 0``), so its final state stays right there, as
the port's does (unlike RWKV6's ``wkv6``, whose padded zero decay zeroes
the state, ROADMAP.md R6). Both are also held against a composition of
single steps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm

TOL = dict(rtol=1e-5, atol=1e-6)
DI, ST = 12, 8


def _inputs(b, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, DI)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, DI)))).astype(np.float32) * 0.3
    a_log = (rng.standard_normal((DI, ST)) * 0.5).astype(np.float32)
    bb = rng.standard_normal((b, t, ST)).astype(np.float32)
    c = rng.standard_normal((b, t, ST)).astype(np.float32)
    d = rng.standard_normal(DI).astype(np.float32)
    s0 = rng.standard_normal((b, DI, ST)).astype(np.float32)
    return x, dt, a_log, bb, c, d, s0


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("t", [1, 7, 128, 200])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "initial_state"])
def test_selective_scan_matches_jax(t, with_state):
    x, dt, a_log, b, c, d, s0 = _inputs(2, t, seed=t)
    init = s0 if with_state else None
    jy, js = jssm.selective_scan(*(jnp.asarray(v) for v in (x, dt, a_log, b, c, d)),
                                 initial_state=None if init is None else jnp.asarray(init))
    ty, ts = tssm.selective_scan(*(_t(v) for v in (x, dt, a_log, b, c, d)),
                                 initial_state=None if init is None else _t(init))
    assert ty.dtype == torch.float32 and ts.dtype == torch.float32
    assert tuple(ty.shape) == (2, t, DI) and tuple(ts.shape) == (2, DI, ST)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "initial_state"])
def test_selective_scan_step_matches_jax(with_state):
    x, dt, a_log, b, c, d, s0 = _inputs(3, 1, seed=5)
    state = s0 if with_state else np.zeros_like(s0)
    args = (x[:, 0], dt[:, 0], a_log, b[:, 0], c[:, 0], d, state)
    jy, js = jssm.selective_scan_step(*(jnp.asarray(v) for v in args))
    ty, ts = tssm.selective_scan_step(*(_t(v) for v in args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


def test_scan_past_the_jax_chunk_equals_its_steps():
    """T = 200 from an initial state: the port's scan and the JAX scan
    both equal 200 single steps, in every output and the final state."""
    x, dt, a_log, b, c, d, s0 = _inputs(2, 200, seed=11)
    ys, s = [], _t(s0)
    for i in range(200):
        y, s = tssm.selective_scan_step(_t(x[:, i]), _t(dt[:, i]), _t(a_log), _t(b[:, i]),
                                        _t(c[:, i]), _t(d), s)
        ys.append(y)
    steps = torch.stack(ys, dim=1)
    ty, ts = tssm.selective_scan(*(_t(v) for v in (x, dt, a_log, b, c, d)),
                                 initial_state=_t(s0))
    jy, js = jssm.selective_scan(*(jnp.asarray(v) for v in (x, dt, a_log, b, c, d)),
                                 initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(ty.numpy(), steps.numpy(), **TOL)
    np.testing.assert_allclose(ts.numpy(), s.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jy), steps.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(js), s.numpy(), **TOL)
    assert float(np.abs(np.asarray(js)).max()) > 0


def test_selective_scan_keeps_bf16_outputs():
    """bf16 inputs: y comes back in bf16, the state in float32, both
    within a bf16 step of the float32 scan of the same values."""
    x, dt, a_log, b, c, d, _ = _inputs(1, 9, seed=3)
    bf = [_t(v).to(torch.bfloat16) for v in (x, dt, b, c)]
    y, s = tssm.selective_scan(bf[0], bf[1], _t(a_log), bf[2], bf[3], _t(d))
    y32, s32 = tssm.selective_scan(*(v.float() for v in bf[:2]), _t(a_log),
                                   *(v.float() for v in bf[2:]), _t(d))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), y32.numpy(), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(s.numpy(), s32.numpy(), **TOL)
