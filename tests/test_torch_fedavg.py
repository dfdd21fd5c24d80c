"""K1's entry points (``repro_torch.kernels.fedavg``) against the JAX
package, on the CPU: the port's plain version against the JAX kernel
(Pallas in interpret mode here) and its ``fedavg_apply_ref`` at
``tests/test_kernels.py``'s ``FEDAVG_CASES`` and tolerances (absolute
2e-6 float32, 5e-2 bf16), the paper's §III.G example through
``fedavg_apply_tree``, and the weight row the CUDA wrapper hands the
kernel. Inputs come from a numpy seed and go through both packages. The
CUDA kernel itself is held against the plain version on the card
(``test_torch_wkv6_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.kernels.fedavg import fedavg_apply as jax_fedavg_apply
from repro.kernels.fedavg import fedavg_apply_ref as jax_fedavg_ref
from repro_torch.kernels.fedavg import fedavg_apply, fedavg_apply_ref, fedavg_apply_tree
from repro_torch.kernels.fedavg.fedavg import fedavg_apply_cuda, weight_row

# tests/test_kernels.py's FEDAVG_CASES: (n, d, block_d, dtype)
FEDAVG_CASES = [
    (8, 1000, 256, "float32"),
    (16, 4096, 2048, "float32"),
    (32, 5000, 2048, "bfloat16"),
    (64, 333, 128, "float32"),
    (4, 2048, 4096, "float32"),  # block_d > d
]


def _inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    upd = rng.standard_normal((n, d)).astype(np.float32)
    base = rng.standard_normal(d).astype(np.float32)
    mask = rng.random(n) < 0.7
    w = (np.abs(rng.standard_normal(n)) * 100).astype(np.float32)
    return upd, base, mask, w


@pytest.mark.parametrize("case", FEDAVG_CASES, ids=str)
def test_fedavg_matches_the_jax_kernel_and_reference(case):
    n, d, bd, dtype = case
    upd, base, mask, w = _inputs(n, d)
    ju, jb = (jnp.asarray(a).astype(dtype) for a in (upd, base))
    jm, jw = jnp.asarray(mask), jnp.asarray(w)
    kernel = jax_fedavg_apply(ju, jb, jm, jw, lr=0.9, block_d=bd)
    ref = jax_fedavg_ref(ju, jb, jm, jw, lr=0.9)
    tu, tb = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (upd, base))
    got = fedavg_apply(tu, tb, torch.from_numpy(mask), torch.from_numpy(w), lr=0.9)
    assert got.dtype == tb.dtype and tuple(got.shape) == (d,)
    tol = 5e-2 if dtype == "bfloat16" else 2e-6
    for want in (kernel, ref):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=0, atol=tol)


def test_fedavg_tree_matches_paper_example():
    """The paper's §III.G FedAvg numbers, leaf-wise over a tree."""
    upd = {"w": torch.tensor([[0.2, -0.1], [0.0, 0.0], [0.5, 0.0]])}
    base = {"w": torch.zeros(2)}
    out = fedavg_apply_tree(upd, base, torch.tensor([True, False, True]),
                            torch.tensor([100.0, 1.0, 300.0]))
    np.testing.assert_allclose(out["w"].numpy(), [0.425, -0.025], atol=1e-6)


def test_fedavg_all_masked_is_safe():
    out = fedavg_apply(torch.ones((4, 16)), torch.zeros(16), torch.zeros(4, dtype=torch.bool),
                       torch.ones(4))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), 0.0, atol=1e-6)


def test_the_kernels_weight_row_is_the_jax_wrappers():
    """``lr·m·w / (Σ m·w + 1e-12)`` in the JAX wrapper's order
    (repro/kernels/fedavg/fedavg.py:55-60), to float32 rounding; an
    all-masked row is zeros."""
    _, _, mask, w = _inputs(64, 1, seed=1)
    wn = mask.astype(np.float32) * w
    want = np.asarray(jnp.asarray(0.7, jnp.float32) * jnp.asarray(wn)
                      / (jnp.sum(jnp.asarray(wn)) + 1e-12))
    got = weight_row(torch.from_numpy(mask), torch.from_numpy(w), 0.7)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    zero = weight_row(torch.zeros(4, dtype=torch.bool), torch.ones(4), 1.0)
    assert torch.equal(zero, torch.zeros(4))


def test_fedavg_routes_by_device_and_the_kernel_refuses_the_cpu():
    upd, base, mask, w = (torch.from_numpy(a) for a in _inputs(4, 32, seed=2))
    assert torch.equal(fedavg_apply(upd, base, mask, w, lr=0.5),
                       fedavg_apply_ref(upd, base, mask, w, lr=0.5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fedavg_apply_cuda(upd, base, mask, w)
    with pytest.raises(ValueError, match="no fedavg kernel"):
        fedavg_apply(upd.to("meta"), base.to("meta"), mask.to("meta"), w.to("meta"))
