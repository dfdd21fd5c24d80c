"""K5 and K7, the hand-written CUDA kernels, against their plain versions
on the card, at the cases of the CPU parity tests (numpy-seeded float32
inputs, tolerances 1e-5 for K5 and 2e-5 for K7 as there); K5's bfloat16
(tensor-core) route at the same cases, against the plain version in
float32 rounded once to bf16 (rtol 1e-2, atol 1e-3: one bf16 step);
and K7 at the boundaries of its split plan. These need a CUDA card (an
H100 for sm_90a) and skip without one; the file imports no JAX, so on
the card it runs alone:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_attention_cuda.py
"""
import numpy as np
import pytest
import torch
from _attention_cases import (FLASH_CASES, PAGED_CASES, PAGED_SPLIT_CASES, flash_inputs,
                              paged_inputs)

from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref
from repro_torch.kernels.paged_attention.paged_attention import (paged_attention_cuda,
                                                                 split_plan)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5 and K7 are CUDA kernels with no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain_version(case):
    _card()
    b, h, hkv, sq, sk, hd, window, bidir = case
    q, k, v = (torch.from_numpy(x).cuda() for x in flash_inputs(b, h, hkv, sq, sk, hd))
    # the kernel takes the model layout; the (B, H, S, hd) inputs go in as views
    out = flash_attention_cuda(*(x.transpose(1, 2) for x in (q, k, v)), window=window,
                               bidirectional=bidir).transpose(1, 2)
    ref = flash_attention_ref(q, k, v, window=window, bidirectional=bidir)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_bf16_kernel_matches_plain_version(case):
    """The tensor-core route: bf16 inputs, held against the plain version on
    the same values in float32, rounded once to bf16."""
    _card()
    b, h, hkv, sq, sk, hd, window, bidir = case
    q, k, v = (torch.from_numpy(x).cuda().to(torch.bfloat16)
               for x in flash_inputs(b, h, hkv, sq, sk, hd))
    out = flash_attention_cuda(*(x.transpose(1, 2) for x in (q, k, v)), window=window,
                               bidirectional=bidir).transpose(1, 2)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), window=window,
                              bidirectional=bidir).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               rtol=1e-2, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_SPLIT_CASES, ids=str)
def test_paged_kernel_at_split_boundaries(case):
    _card()
    s, hkv, g, hd, page, n, window, lengths = case
    q, kp, vp, table, lens = (torch.from_numpy(x).cuda()
                              for x in paged_inputs(s, hkv, g, hd, page, n, lengths=lengths))
    assert split_plan(n)[0] > 1  # the case does split the slot's pages
    out = paged_attention(q, kp, vp, table, lens, window)
    ref = paged_attention_ref(q, kp, vp, table, lens, window)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=2e-5)
    # empty slots: exact zeros from the kernel itself, before ops masks them
    raw = paged_attention_cuda(q, kp, vp, table, lens, window=max(window, 0))
    assert not raw[lens == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_paged_kernel_matches_plain_version(case):
    _card()
    s, hkv, g, hd, page, n, window = case
    q, kp, vp, table, lengths = (torch.from_numpy(x).cuda()
                                 for x in paged_inputs(s, hkv, g, hd, page, n))
    out = paged_attention(q, kp, vp, table, lengths, window)
    ref = paged_attention_ref(q, kp, vp, table, lengths, window)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=2e-5)
    assert not out[s // 2].any()  # the empty slot: exact zeros


# head_dim 256 (gemma3-12b: 16 query heads over 8 kv heads, sliding window
# 1,024): K5 keeps q in shared memory at this width (its fragments and
# the 256-wide accumulators would not fit the registers together), K7 is
# the same kernel instantiated wider.
FLASH_256_CASES = [
    (1, 16, 8, 130, 130, 256, 0, False),  # gemma3's heads, ragged tiles
    (1, 16, 8, 300, 300, 256, 100, False),  # a window inside the sequence
    (2, 4, 1, 40, 90, 256, 0, False),  # Sq < Sk, GQA 4, two warps' blocks
    (1, 8, 8, 70, 70, 256, 0, True),  # bidirectional
]
PAGED_256_CASES = [
    (4, 8, 2, 256, 16, 10, -1, [160, 33, 0, 1]),  # gemma3's heads
    (4, 8, 2, 256, 16, 10, 40, [160, 150, 17, 0]),  # window
    (3, 2, 4, 256, 8, 40, -1, [320, 99, 0]),  # 40 pages through the ring
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_256_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_head_dim_256(case, dtype):
    _card()
    b, h, hkv, sq, sk, hd, window, bidir = case
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).cuda().to(dt)
               for x in flash_inputs(b, h, hkv, sq, sk, hd, seed=3))
    out = flash_attention_cuda(*(x.transpose(1, 2) for x in (q, k, v)), window=window,
                               bidirectional=bidir).transpose(1, 2)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), window=window,
                              bidirectional=bidir).to(dt)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_256_CASES, ids=str)
def test_paged_kernel_head_dim_256(case):
    _card()
    s, hkv, g, hd, page, n, window, lengths = case
    q, kp, vp, table, lens = (torch.from_numpy(x).cuda()
                              for x in paged_inputs(s, hkv, g, hd, page, n, lengths=lengths))
    out = paged_attention(q, kp, vp, table, lens, window)
    ref = paged_attention_ref(q, kp, vp, table, lens, window)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=2e-5)
    raw = paged_attention_cuda(q, kp, vp, table, lens, window=max(window, 0))
    assert not raw[lens == 0].any()
    # bf16 pools: against the plain version in float32, rounded once
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, kp, vp))
    outb = paged_attention(qb, kb, vb, table, lens, window)
    refb = paged_attention_ref(qb.float(), kb.float(), vb.float(), table, lens,
                               window).to(torch.bfloat16)
    np.testing.assert_allclose(outb.float().cpu().numpy(), refb.float().cpu().numpy(),
                               rtol=1e-2, atol=1e-3)


# The HYBRID, VLM and ENCDEC families' shapes: hymba-1.5b's 25 query
# heads over 5 kv heads (a group of 5, which no earlier config has) at
# head_dim 64, global and past its 1,024 window; internvl2-2b's 136-row
# prompt (128 tokens and 8 patches: not a whole number of tiles) at
# head_dim 128, 16 heads over 8; seamless-m4t-medium's 16 heads over 16,
# its bidirectional encoder and its cross-attention (Sq 128 and Sq 1
# against 128 source frames).
FLASH_FAMILY_CASES = [
    (1, 25, 5, 128, 128, 64, 0, False),  # hymba prefill, global layer
    (1, 25, 5, 1100, 1100, 64, 1024, False),  # hymba, past the window
    (2, 25, 5, 40, 300, 64, 1024, False),  # group 5, Sq < Sk
    (1, 16, 8, 136, 136, 128, 0, False),  # internvl2 prefill
    (1, 16, 16, 128, 128, 64, 0, True),  # seamless encoder / cross, Sq = Sk
    (8, 16, 16, 1, 128, 64, 0, True),  # seamless decode-step cross
    (2, 16, 16, 5, 128, 64, 0, True),  # cross, Sq < Sk, one tile of q
]
PAGED_FAMILY_CASES = [
    (8, 5, 5, 64, 16, 10, -1, [129, 160, 1, 0, 144, 17, 131, 150]),  # hymba global
    (4, 5, 5, 64, 16, 80, 1024, [1280, 1025, 1024, 0]),  # hymba, past the window
    (8, 8, 2, 128, 16, 11, -1, [137, 168, 140, 0, 1, 150, 160, 138]),  # internvl2
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_FAMILY_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_family_shapes(case, dtype):
    _card()
    b, h, hkv, sq, sk, hd, window, bidir = case
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).cuda().to(dt)
               for x in flash_inputs(b, h, hkv, sq, sk, hd, seed=5))
    out = flash_attention_cuda(*(x.transpose(1, 2) for x in (q, k, v)), window=window,
                               bidirectional=bidir).transpose(1, 2)
    ref = flash_attention_ref(q.float(), k.float(), v.float(), window=window,
                              bidirectional=bidir).to(dt)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAGED_FAMILY_CASES, ids=str)
def test_paged_kernel_family_shapes(case):
    _card()
    s, hkv, g, hd, page, n, window, lengths = case
    q, kp, vp, table, lens = (torch.from_numpy(x).cuda()
                              for x in paged_inputs(s, hkv, g, hd, page, n, lengths=lengths))
    out = paged_attention(q, kp, vp, table, lens, window)
    ref = paged_attention_ref(q, kp, vp, table, lens, window)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=2e-5)
    raw = paged_attention_cuda(q, kp, vp, table, lens, window=max(window, 0))
    assert not raw[lens == 0].any()
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, kp, vp))
    outb = paged_attention(qb, kb, vb, table, lens, window)
    refb = paged_attention_ref(qb.float(), kb.float(), vb.float(), table, lens,
                               window).to(torch.bfloat16)
    np.testing.assert_allclose(outb.float().cpu().numpy(), refb.float().cpu().numpy(),
                               rtol=1e-2, atol=1e-3)
