"""K7's plain version (``repro_torch.kernels.paged_attention``) against the
JAX package's: ``paged_attention_ref`` over the cases of the JAX serving
tests (GQA / MHA, wide heads, sliding windows, window shorter than the
page span), with ragged lengths, an empty slot and page-table entries
past the live pages that name the trash page 0; and the Pallas kernel
``paged_attention_fwd`` in interpret mode at one tiny shape. Inputs from
a numpy seed, float32; tolerance 2e-5 (the JAX package's own for its
kernel against this reference).

The kernel itself runs only on a CUDA card: it is held against the plain
version at these cases in ``test_torch_attention_cuda.py`` (``cuda``
marker, skips without a card) and by ``chip_smoke.py`` on the H100.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _attention_cases import PAGED_CASES, paged_inputs
from _threads import one_thread  # noqa: F401 (autouse)

from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.paged_attention.ref import gather_pages as jax_gather
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref
from repro_torch.kernels.paged_attention import gather_pages, paged_attention, paged_attention_ref
from repro_torch.kernels.paged_attention.paged_attention import paged_attention_cuda

TOL = dict(rtol=0, atol=2e-5)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_plain_version_matches_jax_ref(case):
    s, hkv, g, hd, page, n, window = case
    q, kp, vp, table, lengths = paged_inputs(s, hkv, g, hd, page, n)
    got = paged_attention_ref(*_t(q, kp, vp, table, lengths), window).numpy()
    ref = jax_ref(*map(jnp.asarray, (q, kp, vp, table, lengths)), window)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    assert not got[s // 2].any()  # the empty slot: exact zeros
    # the public entry point takes the plain version on the CPU
    np.testing.assert_array_equal(paged_attention(*_t(q, kp, vp, table, lengths),
                                                  window).numpy(), got)


def test_plain_version_matches_the_interpret_kernel():
    s, hkv, g, hd, page, n, window = 4, 2, 2, 16, 4, 3, 6
    q, kp, vp, table, lengths = paged_inputs(s, hkv, g, hd, page, n, seed=1)
    got = paged_attention_ref(*_t(q, kp, vp, table, lengths), window).numpy()
    kern = jax_paged(*map(jnp.asarray, (q, kp, vp, table, lengths)), window,
                     interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


def test_gather_pages_matches_jax_exactly():
    q, kp, vp, table, lengths = paged_inputs(4, 2, 2, 16, 4, 3, seed=2)
    np.testing.assert_array_equal(gather_pages(*_t(kp, table)).numpy(),
                                  np.asarray(jax_gather(jnp.asarray(kp), jnp.asarray(table))))


def test_dead_pages_and_stale_rows_do_not_leak():
    """Rows at or past a slot's length (stale data of an evicted request)
    and pages the table does not name must not change the output."""
    s, hkv, g, hd, page, n = 3, 2, 2, 16, 4, 3
    q, kp, vp, table, lengths = paged_inputs(s, hkv, g, hd, page, n, seed=3)
    out = paged_attention_ref(*_t(q, kp, vp, table, lengths)).numpy()
    kp2, vp2 = kp.copy(), vp.copy()
    named = set(table.ravel().tolist())
    for p in range(kp.shape[0]):
        if p not in named or p == 0:
            kp2[p], vp2[p] = 1e4, -1e4
    for i, ln in enumerate(lengths):
        for t in range(int(ln), n * page):
            phys = table[i, t // page]
            if phys:
                kp2[phys, t % page], vp2[phys, t % page] = 1e4, -1e4
    out2 = paged_attention_ref(*_t(q, kp2, vp2, table, lengths)).numpy()
    np.testing.assert_array_equal(out, out2)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(*_t(*paged_inputs(2, 1, 1, 16, 4, 2)))

