"""``models.layers.attention_xla_chunked`` (the online-softmax algorithm
over q and kv chunks) against the JAX package's, on numpy-seeded float32
inputs: chunk sizes that force several q and kv chunks, ragged lengths
(padded q and kv chunks), a Python-int window (the static-window path), a
window given as an array (JAX: a traced int32, the port: a tensor; every
kv chunk under the mask), bidirectional, GQA and Sq < Sk. rtol 1e-5
(float32; the two frameworks order the products' sums differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)
GLOBAL = -1

# (B, Sq, Sk, H, Hkv, hd, chunk_q, chunk_kv, window, window as an array, bidirectional)
CASES = [
    (1, 16, 16, 4, 2, 16, 4, 4, GLOBAL, False, False),  # causal, 4 x 4 chunks
    (2, 13, 13, 4, 1, 16, 4, 5, GLOBAL, False, False),  # ragged q and kv, GQA 4
    (1, 37, 37, 4, 2, 16, 8, 6, 9, False, False),  # static window, ragged
    (1, 37, 37, 4, 2, 16, 8, 6, 9, True, False),  # the same window as an array
    (1, 40, 40, 2, 2, 8, 16, 16, 3, False, False),  # window < chunk
    (1, 9, 25, 4, 2, 16, 4, 7, GLOBAL, False, False),  # Sq < Sk, tail-aligned
    (1, 9, 25, 4, 2, 16, 4, 7, 6, False, False),  # Sq < Sk with a window
    (2, 12, 12, 4, 2, 16, 5, 4, GLOBAL, False, True),  # bidirectional, whole kv chunks
    (1, 11, 11, 4, 4, 16, 3, 5, GLOBAL, False, True),  # bidirectional, padded kv
    (1, 20, 20, 4, 2, 16, 64, 64, 7, False, False),  # one chunk each (clamped sizes)
]


def _id(c):
    return "b{}-sq{}-sk{}-h{}-kv{}-hd{}-cq{}-ckv{}-w{}{}{}".format(
        *c[:9], "-array" if c[9] else "", "-bidir" if c[10] else "")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_chunked_attention_matches_jax(case):
    b, sq, sk, h, hkv, hd, cq, ckv, window, as_array, bidir = case
    rng = np.random.default_rng(sq * 131 + sk)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, sq, h, hd), (b, sk, hkv, hd), (b, sk, hkv, hd)))
    qpos = np.arange(sk - sq, sk, dtype=np.int32)
    kpos = np.arange(sk, dtype=np.int32)
    jw = jnp.asarray(window, jnp.int32) if as_array else window
    tw = torch.tensor(window) if as_array else window
    ref = jl.attention_xla_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(qpos), jnp.asarray(kpos), jw, chunk_q=cq,
                                   chunk_kv=ckv, bidirectional=bidir)
    got = tl.attention_xla_chunked(*(torch.from_numpy(x) for x in (q, k, v, qpos, kpos)),
                                   tw, chunk_q=cq, chunk_kv=ckv, bidirectional=bidir)
    assert tuple(got.shape) == (b, sq, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if not bidir:  # where nothing is padded into view, chunking changes no value
        plain = tl.attention_xla(*(torch.from_numpy(x) for x in (q, k, v, qpos, kpos)),
                                 window)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_select_attention_routes_chunked_and_auto():
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 10, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 10, 2, 16)).astype(np.float32))
    pos = torch.arange(10)
    got = tl.select_attention("xla_chunked", q, k, k, pos, pos, 4, chunk_q=3, chunk_kv=4)
    np.testing.assert_allclose(got.numpy(), tl.attention_xla(q, k, k, pos, pos, 4).numpy(),
                               **TOL)
