"""K5's plain version (``repro_torch.kernels.flash_attention``) against the
JAX package's: ``flash_attention_ref`` and the Pallas kernel
``flash_attention_fwd`` in interpret mode (small tiles, so causal and
window tiles are skipped), at tiny shapes: causal, window,
bidirectional, GQA 2 and 4 and none, Sq < Sk. Inputs from a numpy seed,
float32; tolerance 1e-5 (both compute in float32 and differ in the order
of their sums and in exp, a few ulps of O(1) outputs).

The kernel itself runs only on a CUDA card: it is held against the plain
version at these cases in ``test_torch_attention_cuda.py`` (``cuda``
marker, skips without a card) and by ``chip_smoke.py`` on the H100 at the
serving slice's shapes and edge shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _attention_cases import FLASH_CASES, flash_inputs
from _threads import one_thread  # noqa: F401 (autouse)

from repro.kernels.flash_attention import flash_attention as jax_ops_flash
from repro.kernels.flash_attention.flash_attention import flash_attention_fwd
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_plain_version_matches_jax_ref_and_interpret_kernel(case):
    b, h, hkv, sq, sk, hd, window, bidir = case
    q, k, v = flash_inputs(b, h, hkv, sq, sk, hd)
    got = flash_attention_ref(*map(torch.from_numpy, (q, k, v)), window=window,
                              bidirectional=bidir).numpy()
    ref = jax_ref(*map(jnp.asarray, (q, k, v)), window=window, bidirectional=bidir)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    kern = flash_attention_fwd(*map(jnp.asarray, (q, k, v)), window=window,
                               bidirectional=bidir, block_q=8, block_kv=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


@pytest.mark.parametrize("window", [-1, 5])
def test_ops_takes_the_model_layout_and_window_convention(window):
    """``ops.flash_attention``: (B, S, H, hd) in and out, window -1 =
    global, as the JAX wrapper (which runs the kernel in interpret mode
    on the CPU)."""
    q, k, v = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
               for x in flash_inputs(2, 4, 2, 16, 16, 16, seed=1))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    ref = jax_ops_flash(*map(jnp.asarray, (q, k, v)), window=window)
    assert tuple(got.shape) == (2, 16, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_plain_version_keeps_the_input_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in flash_inputs(1, 4, 2, 8, 8, 16))
    out = flash_attention_ref(q, k, v)
    assert out.dtype == torch.bfloat16
    f32 = flash_attention_ref(q.float(), k.float(), v.float())
    np.testing.assert_allclose(out.float().numpy(), f32.to(torch.bfloat16).float().numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = map(torch.from_numpy, flash_inputs(1, 4, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)

