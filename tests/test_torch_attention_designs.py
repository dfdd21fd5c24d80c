"""The arithmetic of K5's and K7's card designs, emulated in PyTorch on the
CPU and held against the JAX package (the CUDA kernels themselves run only
on a card: ``test_torch_attention_cuda.py`` and ``chip_smoke.py``).

* K7 splits a slot's pages across the blocks of a cluster: each block
  keeps an f32 partial (m, l, acc) over its pages, block rank 0 merges
  them with the reference's guards. The emulation below does the same
  page by page, for every split count from 1 to n_pages at the JAX
  serving tests' cases (float32, 1e-5, the empty slot exact zeros), and
  at the split plan's boundary cases.
* The host's split plan reads the table's width only.
* K5's bf16 route: scores in f32 from exact bf16 products, the scale in
  f32, an online softmax in base 2 over 64-key tiles (32 at head_dim
  256), and P split into bf16 hi and lo for the P·V product with f32
  accumulation; held against the Pallas kernel in interpret mode (and,
  over several tiles, the JAX reference) on bf16 inputs within
  ``chip_smoke.ATTN_TOL["bfloat16"]``.

Inputs from a numpy seed.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _attention_cases import (FLASH_CASES, PAGED_CASES, PAGED_SPLIT_CASES, flash_inputs,
                              paged_inputs)
from _threads import one_thread  # noqa: F401 (autouse)

from repro.kernels.flash_attention.flash_attention import flash_attention_fwd
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref
from repro_torch.kernels.paged_attention.paged_attention import MAX_SPLITS, split_plan

NEG_INF = -1e30
def tc_bkv(hd: int) -> int:
    """K5's key tile on the bf16 route: 64 keys, 32 past head_dim 128."""
    return 32 if hd > 128 else 64


def _attn_tol():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.ATTN_TOL["bfloat16"]


def _guarded(m):
    """The reference's guards: m_safe for a row with nothing live yet."""
    return torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)


def _dead(m):
    return torch.where(m <= NEG_INF / 2, torch.full_like(m, NEG_INF), m)


# ---- K7: split-KV with an in-cluster merge ---------------------------- #

def paged_split_merge(q, kp, vp, table, lengths, window, splits):
    """K7's arithmetic with ``splits`` blocks of ceil(n_pages / splits)
    pages. q (S, H, hd), pools (P, page, Hkv, hd), float32; ``window`` in
    the model convention (-1 = unbounded)."""
    s, h, hd = q.shape
    _, page, hkv, _ = kp.shape
    n = table.shape[1]
    g = h // hkv
    pps = -(-n // splits)
    win = 0 if window < 0 else window
    qf = q.reshape(s, hkv, g, hd) * hd ** -0.5
    q_pos = lengths.long() - 1
    parts = []
    for r in range(splits):
        m = torch.full((s, hkv, g), NEG_INF)
        l = torch.zeros((s, hkv, g))
        acc = torch.zeros((s, hkv, g, hd))
        for p in range(r * pps, min((r + 1) * pps, n)):
            first_k = p * page
            live = first_k < lengths.long()
            if win > 0:
                live &= (first_k + page - 1) > q_pos - win
            k, v = kp[table[:, p].long()], vp[table[:, p].long()]  # (S, page, Hkv, hd)
            sc = torch.einsum("shgd,sphd->shgp", qf, k)
            k_pos = first_k + torch.arange(page)
            vis = k_pos[None, :] <= q_pos[:, None]
            if win > 0:
                vis &= (q_pos[:, None] - k_pos[None, :]) < win
            sc = torch.where(vis[:, None, None, :], sc, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, sc.amax(-1))
            m_safe = _guarded(m_new)
            corr = torch.exp(_dead(m) - m_safe)
            pr = torch.exp(sc - m_safe[..., None])
            l_new = l * corr + pr.sum(-1)
            acc_new = acc * corr[..., None] + torch.einsum("shgp,sphd->shgd", pr, v)
            lv = live[:, None, None]  # a dead page leaves the block's state as it is
            m = torch.where(lv, m_new, m)
            l = torch.where(lv, l_new, l)
            acc = torch.where(lv[..., None], acc_new, acc)
        parts.append((m, l, acc))
    m_star = torch.stack([m for m, _, _ in parts]).amax(0)
    m_safe = _guarded(m_star)
    l_sum = torch.zeros_like(m_star)
    out = torch.zeros((s, hkv, g, hd))
    for m, l, acc in parts:
        w = torch.exp(_dead(m) - m_safe)
        l_sum = l_sum + w * l
        out = out + w[..., None] * acc
    return (out / torch.clamp(l_sum, min=1e-30)[..., None]).reshape(s, h, hd)


def _paged_case_ids():
    return [(case, splits) for case in PAGED_CASES for splits in range(1, case[5] + 1)]


@pytest.mark.parametrize("case,splits", _paged_case_ids(), ids=str)
def test_k7_split_and_merge_matches_jax_ref(case, splits):
    s, hkv, g, hd, page, n, window = case
    q, kp, vp, table, lengths = paged_inputs(s, hkv, g, hd, page, n)
    got = paged_split_merge(*map(torch.from_numpy, (q, kp, vp, table, lengths)), window,
                            splits).numpy()
    ref = jax_paged_ref(*map(jnp.asarray, (q, kp, vp, table, lengths)), window)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert not got[lengths == 0].any()  # the empty slot: exact zeros


@pytest.mark.parametrize("case", PAGED_SPLIT_CASES, ids=str)
def test_k7_split_plan_boundaries_match_jax_ref(case):
    """The split plan's own (splits, pps) at its boundaries: a slot with
    fewer live pages than splits, one live token, the full span, a window
    that kills whole splits, more pages per split than the ring holds."""
    s, hkv, g, hd, page, n, window, lengths = case
    q, kp, vp, table, lens = paged_inputs(s, hkv, g, hd, page, n, lengths=lengths)
    splits, _ = split_plan(n)
    got = paged_split_merge(*map(torch.from_numpy, (q, kp, vp, table, lens)), window,
                            splits).numpy()
    ref = jax_paged_ref(*map(jnp.asarray, (q, kp, vp, table, lens)), window)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert not got[lens == 0].any()


# ---- K7: the host's split plan ---------------------------------------- #

@pytest.mark.parametrize("n_pages", [1, 2, 3, 7, 8, 9, 10, 16, 17, 40, 63, 64, 65, 1000])
def test_split_plan_fits_one_cluster(n_pages):
    splits, pps = split_plan(n_pages)
    assert 1 <= splits <= MAX_SPLITS
    assert splits * pps >= n_pages  # every page has a block
    assert (splits - 1) * pps < n_pages  # and every block a page
    assert pps == -(-n_pages // MAX_SPLITS)  # the fewest pages per block


def test_split_plan_reads_no_tensor():
    """The plan comes from the table's width, a Python int: handing it a
    tensor (whose value would need the device) raises."""
    assert split_plan(10) == (5, 2)
    assert split_plan(torch.zeros((8, 10), dtype=torch.int32).shape[1]) == (5, 2)
    for bad in (torch.tensor(10), np.int64(10), 0):
        with pytest.raises(TypeError):
            split_plan(bad)


# ---- K5: the tensor-core route's roundings ---------------------------- #

def flash_tc_emulation(q, k, v, *, window=0, bidirectional=False):
    """K5's bf16 route on bf16 q (B, H, Sq, hd), k/v (B, Hkv, Sk, hd): f32
    scores of exact bf16 products scaled by hd^-0.5·log2(e) in f32, an
    online softmax in base 2 over 64-key tiles (32 at hd 256) with the reference's
    guards, P·V as bf16(P)·V + bf16(P - bf16(P))·V accumulated in f32.
    Tiles the kernel skips add nothing here (their weights are
    2^(-1e30 - m_safe) = 0 and their correction 1), so every tile is
    visited. Returns bf16."""
    b, h, sq, hd = q.shape
    _, hkv, sk, _ = k.shape
    g = h // hkv
    scale = torch.tensor(hd ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    kf = torch.repeat_interleave(k.float(), g, dim=1)
    vf = torch.repeat_interleave(v.float(), g, dim=1)
    qf = q.float()
    q_pos = torch.arange(sq) + (sk - sq)
    m = torch.full((b, h, sq), NEG_INF)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, hd))
    bkv = tc_bkv(hd)
    for k0 in range(0, sk, bkv):
        kt, vt = kf[:, :, k0:k0 + bkv], vf[:, :, k0:k0 + bkv]
        sc = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
        if not bidirectional:
            k_pos = k0 + torch.arange(kt.shape[2])
            vis = k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                vis &= (q_pos[:, None] - k_pos[None, :]) < window
            sc = torch.where(vis, sc, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1))
        m_safe = _guarded(m_new)
        corr = torch.exp2(_dead(m) - m_safe)
        p = torch.exp2(sc - m_safe[..., None])
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        acc = acc * corr[..., None] + hi @ vt + lo @ vt
        l = l * corr + p.sum(-1)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)


def _bf16_inputs(b, h, hkv, sq, sk, hd, seed=0):
    """numpy float32 inputs rounded to bf16 (as float32 arrays, exactly)."""
    return tuple(torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                 for x in flash_inputs(b, h, hkv, sq, sk, hd, seed=seed))


def _assert_within(got, ref, tol):
    rtol, atol = tol
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    bad = np.abs(got - ref) > atol + rtol * np.abs(ref)
    assert not bad.any(), f"max abs err {np.abs(got - ref).max()}"


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_k5_tensor_core_roundings_match_interpret_kernel(case):
    b, h, hkv, sq, sk, hd, window, bidir = case
    q, k, v = _bf16_inputs(b, h, hkv, sq, sk, hd)
    got = flash_tc_emulation(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                             window=window, bidirectional=bidir)
    kern = flash_attention_fwd(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                               window=window, bidirectional=bidir, block_q=8, block_kv=8,
                               interpret=True)
    assert kern.dtype == jnp.bfloat16
    _assert_within(got.float().numpy(), np.asarray(kern, np.float32), _attn_tol())


# Several 64-key tiles: the online softmax across tiles, a window that
# drops whole tiles, ragged Sk, Sq < Sk, hd 128; and hd 256 over its
# 32-key tiles (gemma3-12b's head_dim, GQA 2, a window).
MULTI_TILE_CASES = [
    (1, 4, 1, 150, 150, 64, 0, False),
    (1, 4, 2, 130, 130, 32, 40, False),
    (1, 2, 2, 40, 200, 128, 0, False),
    (2, 2, 1, 70, 70, 16, 0, True),
    (1, 4, 2, 100, 100, 256, 0, False),
    (1, 2, 1, 70, 90, 256, 24, False),
]


@pytest.mark.parametrize("case", MULTI_TILE_CASES, ids=str)
def test_k5_tensor_core_roundings_over_several_tiles_match_jax_ref(case):
    b, h, hkv, sq, sk, hd, window, bidir = case
    q, k, v = _bf16_inputs(b, h, hkv, sq, sk, hd, seed=3)
    got = flash_tc_emulation(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                             window=window, bidirectional=bidir)
    ref = jax_flash_ref(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), window=window,
                        bidirectional=bidir)
    _assert_within(got.float().numpy(), np.asarray(ref, np.float32), _attn_tol())
