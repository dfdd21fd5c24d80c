"""K6's entry point (``repro_torch.kernels.wkv6``) and the plain RWKV6
recurrences of ``repro_torch.models.ssm`` against the JAX package, on the
CPU. Inputs come from a numpy seed (r, v ~ N(0, 1), k ~ N(0, 1)/2,
u ~ 0.3·N(0, 1), w = exp(-exp(ww)), ww uniform) and go through both
packages.

On the CPU the port's ``wkv6`` is the JAX wrapper's clamp on w around
the plain recurrence; it is held against the JAX wrapper, whose
Pallas kernel runs in interpret mode here, at ``tests/test_kernels.py``'s
``WKV_CASES`` and tolerances (absolute 1e-4 float32, 1e-1 bf16), and
against the sequential references at 1e-5 (float32: the same recurrence,
sums in another order). With strong decay (ww up to 3, w at the e^-20
clamp) the chunked closed form of the TPU kernel divides by decay
products that leave float32's range; the port is held there against the
plain recurrence alone. The CUDA kernel itself is held against this
plain version on the card (``test_torch_wkv6_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.kernels.wkv6 import ops as jax_ops
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models import ssm as jax_ssm
from repro_torch.kernels.wkv6 import ops, wkv6, wkv6_plain, wkv6_ref
from repro_torch.kernels.wkv6.wkv6 import wkv6_cuda
from repro_torch.models import ssm

# tests/test_kernels.py's WKV_CASES: (b, t, h, dk, dv, chunk, dtype)
WKV_CASES = [
    (1, 64, 2, 64, 64, 32, "float32"),
    (2, 128, 4, 64, 64, 32, "float32"),
    (1, 96, 1, 32, 64, 32, "float32"),
    (2, 64, 2, 64, 64, 64, "float32"),
    (1, 64, 2, 64, 64, 16, "float32"),
    (1, 64, 2, 64, 64, 32, "bfloat16"),
]
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, t, h, dk=64, dv=64, dtype="float32", ww=(-4.0, 0.5), seed=0):
    """numpy float32 r, k, v, w (w = exp(-exp(ww)), rounded to ``dtype``
    as the others are) and u."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, t, h, dk))
    k = 0.5 * rng.standard_normal((b, t, h, dk))
    v = rng.standard_normal((b, t, h, dv))
    w = np.exp(-np.exp(rng.uniform(*ww, (b, t, h, dk))))
    u = 0.3 * rng.standard_normal((h, dk))
    return [a.astype(np.float32) for a in (r, k, v, w, u)], dtype


def _jax(arrays, dtype):
    *rkvw, u = arrays
    return [jnp.asarray(a).astype(dtype) for a in rkvw] + [jnp.asarray(u)]


def _torch(arrays, dtype):
    *rkvw, u = arrays
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in rkvw] + [torch.from_numpy(u)]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv6_matches_the_jax_wrapper_and_kernel(case):
    b, t, h, dk, dv, chunk, dtype = case
    arrays, _ = _inputs(b, t, h, dk, dv, dtype)
    yj, sj = jax_ops.wkv6(*_jax(arrays, dtype), chunk=chunk)
    yt, st = wkv6(*_torch(arrays, dtype))
    assert yt.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    tol = 1e-1 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=0, atol=tol)
    np.testing.assert_allclose(_np(st), _np(sj), rtol=0, atol=tol)


@pytest.mark.parametrize("b,t,h", [(1, 40, 2), (2, 33, 3), (1, 7, 1)])
def test_wkv6_matches_the_jax_sequential_references(b, t, h):
    """The plain recurrence of the port, through ``wkv6`` (zero state),
    its ``ref.py`` and ``models.ssm`` (from a state), against the JAX
    package's ``wkv6_ref`` and ``ssm.wkv6``."""
    arrays, _ = _inputs(b, t, h, seed=1)
    jx, tx = _jax(arrays, "float32"), _torch(arrays, "float32")
    yr, sr = jax_wkv6_ref(*jx)
    for got in (wkv6(*tx), wkv6_ref(*tx), ssm.wkv6(*tx)):
        np.testing.assert_allclose(_np(got[0]), _np(yr), **TOL)
        np.testing.assert_allclose(_np(got[1]), _np(sr), **TOL)
    # JAX's ssm.wkv6 pads T to its checkpoint chunk with w = 0, which zeroes
    # the final state unless the chunk divides T (ROADMAP.md R6): chunk=T.
    s0 = np.random.default_rng(2).standard_normal((b, h, 64, 64)).astype(np.float32)
    yj, sj = jax_ssm.wkv6(*jx, initial_state=jnp.asarray(s0), chunk=t)
    for fn in (wkv6_ref, ssm.wkv6):
        yt, st = fn(*tx, initial_state=torch.from_numpy(s0))
        np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
        np.testing.assert_allclose(_np(st), _np(sj), **TOL)


@pytest.mark.parametrize("t", [50, 100])
def test_wkv6_pads_a_ragged_t_as_the_jax_wrapper_does(t):
    """T not a multiple of the chunk: the JAX wrapper pads with w = 1 and
    zeros, which leaves the state unchanged, and cuts y back to T; the
    port's recurrence stops at T and gives the same y and state."""
    arrays, _ = _inputs(2, t, 2, seed=3)
    yj, sj = jax_ops.wkv6(*_jax(arrays, "float32"))
    yt, st = wkv6(*_torch(arrays, "float32"))
    assert tuple(yt.shape) == (2, t, 2, 64)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(st), _np(sj), rtol=0, atol=1e-4)
    yr, sr = wkv6_ref(*_torch(arrays, "float32"))
    np.testing.assert_allclose(_np(st), _np(sr), **TOL)
    np.testing.assert_allclose(_np(yt), _np(yr), **TOL)


def test_wkv6_state_carry_composes():
    """Two half-sequences with the state carried == one full pass, in the
    port and against the JAX reference."""
    arrays, _ = _inputs(1, 64, 2, ww=(-3.0, 0.0), seed=4)
    tx = _torch(arrays, "float32")
    y_full, s_full = wkv6(*tx)
    first = [x[:, :32] for x in tx[:4]] + [tx[4]]
    second = [x[:, 32:] for x in tx[:4]] + [tx[4]]
    y1, s1 = wkv6(*first)
    y2, s2 = ssm.wkv6(*second, initial_state=s1)
    np.testing.assert_allclose(_np(y_full[:, 32:]), _np(y2), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(s_full), _np(s2), rtol=0, atol=1e-5)
    yj, sj = jax_wkv6_ref(*_jax(arrays, "float32"))
    np.testing.assert_allclose(_np(torch.cat([y1, y2], dim=1)), _np(yj), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_with_strong_decay_is_finite_and_equals_the_plain_recurrence(dtype):
    """ww up to 3: w = exp(-e^3) < e^-20 at the clamp for a third of the
    channels. Held against the JAX sequential reference on the clamped w
    (float32: 1e-5; bf16 inputs: y to one bf16 rounding)."""
    arrays, _ = _inputs(1, 96, 2, dtype=dtype, ww=(-4.0, 3.0), seed=5)
    yt, st = wkv6(*_torch(arrays, dtype))
    assert torch.isfinite(yt).all() and torch.isfinite(st).all()
    r, k, v, w, u = _jax(arrays, dtype)
    w = jnp.maximum(w, jnp.asarray(jnp.exp(-20.0), w.dtype))
    yr, sr = jax_wkv6_ref(r, k, v, w, u)
    np.testing.assert_allclose(_np(st), _np(sr), **TOL)
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(yt), _np(yr), rtol=rtol, atol=1e-5)


def test_wkv6_step_matches_jax():
    arrays, _ = _inputs(3, 1, 2, seed=6)
    r, k, v, w, u = (a[:, 0] if a.ndim == 4 else a for a in arrays)
    s0 = np.random.default_rng(7).standard_normal((3, 2, 64, 64)).astype(np.float32)
    yj, sj = jax_ssm.wkv6_step(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)))
    yt, st = ssm.wkv6_step(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)))
    np.testing.assert_allclose(_np(yt), _np(yj), **TOL)
    np.testing.assert_allclose(_np(st), _np(sj), **TOL)


def test_wkv6_routes_by_device_and_the_kernel_refuses_the_cpu():
    arrays, _ = _inputs(1, 8, 2, seed=8)
    tx = _torch(arrays, "float32")
    y, s = wkv6(*tx)
    yp, sp = wkv6_plain(*tx)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6_cuda(*tx)
    meta = [x.to("meta") for x in tx]
    with pytest.raises(ValueError, match="no wkv6 kernel"):
        wkv6(*meta)
    # the clamp is e^-20 rounded to w's dtype, as the JAX wrapper's
    for dtype in (torch.float32, torch.bfloat16):
        want = np.asarray(jnp.asarray(jnp.exp(-20.0), jnp.dtype(str(dtype)[6:])),
                          np.float32)
        assert ops.w_floor(dtype) == float(want)
