"""K6 (the RWKV6 recurrence) and K1 (the fused FedAvg apply), the
hand-written CUDA kernels, against their plain versions on the card
(numpy-seeded inputs). These need a CUDA card (an H100 for sm_90a) and
skip without one; the file imports no JAX, so on the card it runs alone:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_wkv6_cuda.py

Tolerances: K6's state to 1e-6 of max |S| (the kernel sums each element's
decayed terms chunk by chunk and forms each decay as a running product of
the chunk's w, a few float32 roundings from the stepwise product; the CPU
emulation of that arithmetic, tests/test_torch_wkv6_design.py, stays within
it), y to 1e-5 in float32 (the same sums in another order) and to one bf16
rounding (2^-7 relative) plus 1e-5 of max |y| in bf16; K1 to the JAX tests'
absolute 2e-6 (float32) and 5e-2 (bf16), also on contiguous views that
start one or more elements past a 16-byte boundary (every row and both
ends of the buffer misaligned for the kernel's bulk copies).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fedavg import fedavg_apply, fedavg_apply_ref
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
from repro_torch.kernels.wkv6.wkv6 import wkv6_cuda

# (B, T, H, dtype, ww range): the prefill's shape, ragged T, T < 32,
# float32 and strong decay (ww up to 3: w at the e^-20 clamp).
WKV_CUDA_CASES = [
    (1, 128, 32, "bfloat16", (-4.0, 0.5)),
    (2, 100, 4, "bfloat16", (-4.0, 0.5)),
    (1, 20, 2, "float32", (-4.0, 0.5)),
    (2, 64, 4, "float32", (-4.0, 0.5)),
    (1, 96, 4, "float32", (-4.0, 3.0)),
]
FEDAVG_CUDA_CASES = [(8, 1000, "float32"), (32, 5000, "bfloat16"), (64, 333, "float32"),
                     (64, 112_766, "float32")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 and K1 are CUDA kernels with no CPU mode")


def _wkv_inputs(b, t, h, dtype, ww_range, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, t, h, 64)
    ww = rng.uniform(*ww_range, shape)
    arrays = (rng.standard_normal(shape), 0.5 * rng.standard_normal(shape),
              rng.standard_normal(shape), np.exp(-np.exp(ww)))
    dt = getattr(torch, dtype)
    r, k, v, w = (torch.from_numpy(a.astype(np.float32)).cuda().to(dt) for a in arrays)
    u = torch.from_numpy((0.3 * rng.standard_normal((h, 64))).astype(np.float32)).cuda()
    return r, k, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_CUDA_CASES, ids=str)
def test_wkv6_kernel_matches_plain_version(case):
    _card()
    b, t, h, dtype, ww_range = case
    r, k, v, w, u = _wkv_inputs(b, t, h, dtype, ww_range)
    before = wkv6_cuda.launches
    y, s = wkv6(r, k, v, w, u)
    assert wkv6_cuda.launches == before + 1
    yp, sp = wkv6_plain(r, k, v, w, u)
    for x in (y, s):
        assert torch.isfinite(x).all()
    yo, yr = y.float().cpu().numpy(), yp.float().cpu().numpy()
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(yo, yr, rtol=rtol, atol=1e-5 * np.abs(yr).max())
    np.testing.assert_allclose(s.cpu().numpy(), sp.cpu().numpy(), rtol=0,
                               atol=1e-6 * float(sp.abs().max()))


@pytest.mark.cuda
def test_wkv6_kernel_refuses_other_head_sizes():
    _card()
    x = torch.zeros((1, 8, 2, 32), device="cuda")
    with pytest.raises(ValueError, match="K = V = 64"):
        wkv6_cuda(x, x, x, x, torch.zeros((2, 32), device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FEDAVG_CUDA_CASES, ids=str)
def test_fedavg_kernel_matches_plain_version(case):
    _card()
    n, d, dtype = case
    rng = np.random.default_rng(1)
    dt = getattr(torch, dtype)
    upd = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).cuda().to(dt)
    base = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).cuda().to(dt)
    mask = torch.from_numpy(rng.random(n) < 0.7).cuda()
    w = torch.from_numpy((np.abs(rng.standard_normal(n)) * 100).astype(np.float32)).cuda()
    out = fedavg_apply(upd, base, mask, w, lr=0.9)
    ref = fedavg_apply_ref(upd, base, mask, w, lr=0.9)
    assert out.dtype == base.dtype
    tol = 5e-2 if dtype == "bfloat16" else 2e-6
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               rtol=0, atol=tol)


# (N, D, dtype, offset): contiguous views whose first element lies
# ``offset`` elements past a 16-byte boundary, so every row and both ends
# of the buffer are misaligned for the kernel's bulk copies.
FEDAVG_VIEW_CASES = [(8, 1000, "float32", 1), (64, 333, "float32", 3),
                     (32, 5000, "bfloat16", 1), (16, 4999, "bfloat16", 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FEDAVG_VIEW_CASES, ids=str)
def test_fedavg_kernel_on_a_misaligned_view(case):
    _card()
    n, d, dtype, offset = case
    rng = np.random.default_rng(2)
    dt = getattr(torch, dtype)
    flat = torch.from_numpy(rng.standard_normal(n * d + offset).astype(np.float32))
    upd = flat.cuda().to(dt)[offset:].view(n, d)
    assert upd.is_contiguous() and upd.data_ptr() % 16 != 0
    base = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).cuda().to(dt)
    mask = torch.from_numpy(rng.random(n) < 0.7).cuda()
    w = torch.from_numpy((np.abs(rng.standard_normal(n)) * 100).astype(np.float32)).cuda()
    out = fedavg_apply(upd, base, mask, w, lr=0.9)
    ref = fedavg_apply_ref(upd, base, mask, w, lr=0.9)
    assert out.dtype == base.dtype
    tol = 5e-2 if dtype == "bfloat16" else 2e-6
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               rtol=0, atol=tol)
