"""The arithmetic of K6's CUDA kernel on the CPU: the chunk-parallel RWKV6
recurrence, emulated in torch float32 (``tests/_wkv6_chunked.py``: phases
A, B and C and the running products in the kernel's order), against the
JAX package's sequential ``wkv6_ref`` and its Pallas ``wkv6_fwd`` in
interpret mode. Inputs come from a numpy seed (r, v ~ N(0, 1),
k ~ N(0, 1)/2, u ~ 0.3·N(0, 1), w = exp(-exp(ww)), ww uniform).

Tolerances are those the kernel is held to on the card (``chip_smoke.py``
``K6_Y_RTOL`` / ``K6_ATOL_OF_MAX``, ``tests/test_torch_wkv6_cuda.py``):
the state to 1e-6 of max |S| (the chunked form sums each element's
decayed terms in another order and forms each decay as a running product
of its own; both round within a few float32 steps of the sequential
one), y to 1e-5 relative in float32 plus 1e-5 of max |y| (the same, and
the sums over K and over the chunk in another order) and to one bf16
rounding (2^-7 relative) with bf16 inputs. Against the Pallas kernel,
whose closed form divides by decay products, the JAX tests' 1e-4 holds
where that form stays finite (ww up to 0.5). With strong decay (ww up to
3, w at the e^-20 clamp for a third of the channels) only the sequential
reference is finite, and the emulation must be too. The state is held
against ``wkv6_ref``, never against the JAX model's (ROADMAP.md R6).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _wkv6_chunked import TW, wkv6_chunked
from _threads import one_thread  # noqa: F401 (autouse)
from repro.kernels.wkv6 import ops as jax_ops
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref

CHUNKS = [8, 16, 32]
T_LENGTHS = [1, 7, 16, 20, 33, 100, 128]
HEADS = 2
STATE_ATOL_OF_MAX = 1e-6
Y_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
Y_ATOL_OF_MAX = 1e-5
NORMAL, STRONG = (-4.0, 0.5), (-4.0, 3.0)


def _w_floor(dtype):
    return float(jnp.asarray(jnp.exp(-20.0), jnp.dtype(dtype)).astype(jnp.float32))


@functools.cache
def _arrays(b, t, ww, dtype, seed):
    """numpy float32 r, k, v, w, u with r, k, v, w rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    shape = (b, t, HEADS, 64)
    r = rng.standard_normal(shape)
    k = 0.5 * rng.standard_normal(shape)
    v = rng.standard_normal(shape)
    w = np.exp(-np.exp(rng.uniform(*ww, shape)))
    u = 0.3 * rng.standard_normal((HEADS, 64))
    rkvw = [np.array(jnp.asarray(a, jnp.float32).astype(dtype).astype(jnp.float32))
            for a in (r, k, v, w)]
    return (*rkvw, u.astype(np.float32))


@functools.cache
def _reference(b, t, ww, dtype, seed):
    """JAX ``wkv6_ref`` on the clamped w: (y rounded to ``dtype``, state)."""
    r, k, v, w, u = _arrays(b, t, ww, dtype, seed)
    w = np.maximum(w, _w_floor(dtype))
    y, s = jax_wkv6_ref(*(jnp.asarray(x).astype(dtype) for x in (r, k, v, w)), jnp.asarray(u))
    return np.asarray(y.astype(jnp.float32)), np.asarray(s)


def _emulated(b, t, ww, dtype, seed, chunk):
    r, k, v, w, u = _arrays(b, t, ww, dtype, seed)
    dt = getattr(torch, dtype)
    y, s = wkv6_chunked(*(torch.from_numpy(x).to(dt) for x in (r, k, v, w)),
                        torch.from_numpy(u), chunk=chunk, w_min=_w_floor(dtype))
    assert y.dtype == dt and s.dtype == torch.float32
    assert tuple(y.shape) == (b, t, HEADS, 64) and tuple(s.shape) == (b, HEADS, 64, 64)
    return y.float().numpy(), s.numpy()


def _hold(y, s, yr, sr, dtype):
    assert np.isfinite(y).all() and np.isfinite(s).all()
    np.testing.assert_allclose(s, sr, rtol=0, atol=STATE_ATOL_OF_MAX * np.abs(sr).max())
    np.testing.assert_allclose(y, yr, rtol=Y_RTOL[dtype],
                               atol=Y_ATOL_OF_MAX * np.abs(yr).max())


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("t", T_LENGTHS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_form_matches_the_sequential_reference(chunk, t, b):
    """Every chunk size at every T, ragged last chunks included (T = 1, 7,
    20, 33, 100 leave one), float32."""
    y, s = _emulated(b, t, NORMAL, "float32", 0, chunk)
    _hold(y, s, *_reference(b, t, NORMAL, "float32", 0), "float32")


@pytest.mark.parametrize("t", [20, 100, 128])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_form_with_bf16_inputs(chunk, t):
    """bf16 r, k, v, w (the served model's dtype): y rounded once to bf16,
    within one bf16 rounding of the reference's."""
    y, s = _emulated(2, t, NORMAL, "bfloat16", 1, chunk)
    _hold(y, s, *_reference(2, t, NORMAL, "bfloat16", 1), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_form_with_strong_decay_stays_finite(chunk, dtype):
    """ww up to 3: w at the e^-20 clamp for a third of the channels, so
    products over a chunk reach e^-640 and underflow; nothing is divided,
    so the emulation stays finite and agrees with the sequential form."""
    y, s = _emulated(1, 128, STRONG, dtype, 2, chunk)
    _hold(y, s, *_reference(1, 128, STRONG, dtype, 2), dtype)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_the_state_is_carried_from_window_to_window(chunk):
    """T = 300: three windows of the kernel's staging (128, 128, 44), the
    state carried between them, the last chunk ragged."""
    assert 300 > 2 * TW
    y, s = _emulated(1, 300, NORMAL, "float32", 3, chunk)
    _hold(y, s, *_reference(1, 300, NORMAL, "float32", 3), "float32")


@functools.cache
def _pallas(b, t):
    """The JAX wrapper (pad to its chunk, clamp) around the Pallas kernel,
    in interpret mode off the TPU."""
    r, k, v, w, u = _arrays(b, t, NORMAL, "float32", 4)
    y, s = jax_ops.wkv6(*(jnp.asarray(x) for x in (r, k, v, w, u)))
    return np.asarray(y), np.asarray(s)


@pytest.mark.parametrize("b,t", [(1, 20), (2, 128)])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_form_matches_the_pallas_kernel(chunk, b, t):
    """Where the TPU kernel's closed form stays finite (ww up to 0.5), at
    the JAX tests' tolerance for it (absolute 1e-4, float32)."""
    y, s = _emulated(b, t, NORMAL, "float32", 4, chunk)
    yj, sj = _pallas(b, t)
    np.testing.assert_allclose(y, yj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(s, sj, rtol=0, atol=1e-4)
