"""The streaming design of ``fedavg_kernel`` (K1, K3's weighted sum, K4),
emulated on the CPU and held against the JAX package (the CUDA kernel
itself runs only on a card: ``test_torch_delta_pipeline.py``'s and
``test_torch_wkv6_cuda.py``'s card tests and ``chip_smoke.py``).

* ``fedavg_plan``: the grid covers [0, P) exactly once in ranges that
  start on 16-byte granules and differ by at most one granule, and the
  ring fits a block's shared memory, over the clients, widths and SM
  counts the kernel takes.
* The kernel's reads: per block range, tile and ring stage, each client
  row's bulk copy (its span widened to 16-byte granules, clipped to the
  tensor's aligned interior) and the tensor-end fragments loaded one
  element at a time, into a ring whose slots are reused; then each row
  read back at its own shift. The emulation checks the bulk-copy
  alignment rules, that no byte outside the tensor is read and that every
  value a consumer reads was written by that stage's fill, at base
  offsets of 0-3 float32 and 0-7 bf16 elements.
* The values so read go through ``_pipeline_gates.kernel_model``'s
  arithmetic (clients in order, one FMA each). With every gate off they
  equal the JAX ``delta_pipeline_apply`` (interpret mode) bit for bit, and
  K4 the JAX ``delta_pipeline_partial``; K1 agrees with the JAX
  ``fedavg_apply_ref`` to the JAX tests' tolerances (float32 2e-6, bf16
  5e-2); with gates on, to ``_pipeline_gates``' tolerances.

Inputs from a numpy seed.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _pipeline_gates import kernel_model
from _threads import one_thread  # noqa: F401 (autouse)

from repro.kernels.delta_pipeline import delta_pipeline_apply as jax_apply
from repro.kernels.delta_pipeline import delta_pipeline_partial as jax_partial
from repro.kernels.fedavg import fedavg_apply_ref as jax_fedavg_ref
from repro_torch.kernels.delta_pipeline import delta_pipeline as cu
from repro_torch.kernels.delta_pipeline.ref import _fma, delta_sq_norms_ref
from repro_torch.kernels.fedavg.fedavg import weight_row

P_CASES = (3, 130, 1_000, 1_001, 65_536, 112_766, 112_767)


# ---- (a) the plan ---------------------------------------------------- #

@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("c", [1, 6, 16, 64, 256, 4096])
def test_plan_covers_every_column_once_and_fits_shared_memory(c, elem_bytes):
    for p in P_CASES:
        for n_sms in (132, 7):
            pl = cu.fedavg_plan(c, p, elem_bytes, n_sms)
            g = pl.granule
            assert g * elem_bytes == 16
            granules = -(-p // g)
            assert pl.blocks == min(n_sms, granules)
            ranges = cu.block_ranges(p, g, pl.blocks)
            assert ranges[0][0] == 0 and ranges[-1][1] == p
            for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
                assert hi == lo2  # contiguous, so each column once
            widths = [-(-(hi - lo) // g) for lo, hi in ranges]  # in granules
            assert all(lo % g == 0 for lo, _ in ranges)
            assert all(hi % g == 0 for _, hi in ranges[:-1])
            assert min(widths) >= 1 and max(widths) - min(widths) <= 1
            assert max(widths) * g == pl.cols_per_block
            # tiles and ring
            assert pl.tile_cols % g == 0
            assert 0 < pl.tile_cols <= cu.CONSUMERS * cu.COLS_PER_THREAD
            assert pl.tile_cols == min(pl.cols_per_block, cu.CONSUMERS * cu.COLS_PER_THREAD)
            assert pl.row_stride == pl.tile_cols * elem_bytes + 16
            assert 1 <= pl.rows_per_stage <= c
            assert 1 <= pl.stages <= cu.MAX_STAGES
            tiles = -(-pl.cols_per_block // pl.tile_cols)
            assert pl.stages <= tiles * -(-c // pl.rows_per_stage)
            if tiles * -(-c // pl.rows_per_stage) > 1:
                assert pl.stages >= 2  # one stage fills while one is read
            need = cu.ring_offset(c, pl.tile_cols) + pl.ring_bytes
            assert pl.smem_bytes == need <= cu.MAX_SMEM
            assert pl.c_args() == (pl.blocks, pl.tile_cols, pl.rows_per_stage,
                                   pl.stages, pl.smem_bytes)


def test_plan_at_the_main_paths_shapes():
    """K3 and K1 at the cohort: 132 blocks of 213 or 214 granules, the
    whole block's 64 rows in the ring; K4 a fog's 16 rows; bf16 16 rows a
    stage."""
    k3 = cu.fedavg_plan(64, 112_766, 4, 132)
    assert (k3.blocks, k3.cols_per_block, k3.tile_cols) == (132, 856, 856)
    assert k3.rows_per_stage * k3.stages >= 64
    widths = {-(-(hi - lo) // 4) for lo, hi in cu.block_ranges(112_766, 4, 132)}
    assert widths == {213, 214}  # granules of 4 columns
    k4 = cu.fedavg_plan(16, 112_766, 4, 132)
    assert k4.rows_per_stage * k4.stages == 16
    k1 = cu.fedavg_plan(64, 112_766, 2, 132)
    assert (k1.granule, k1.rows_per_stage) == (8, 16)
    with pytest.raises(ValueError):
        cu.fedavg_plan(4, 100, 8, 132)


# ---- (b) the kernel's reads ------------------------------------------ #

class Emulated:
    """The values ``fedavg_kernel``'s consumers read, produced as its
    producer fills the ring, for a (C, P) array at virtual address
    ``4096 + offset * eb``."""

    def __init__(self, arr: np.ndarray, offset: int, plan):
        c, p = arr.shape
        eb = arr.dtype.itemsize
        self.raw = arr.tobytes()
        self.t0 = 4096 + offset * eb
        self.t1 = self.t0 + len(self.raw)
        in0, in1 = -(-self.t0 // 16) * 16, self.t1 // 16 * 16
        self.fragments = 0
        read = np.zeros((c, p), dtype=np.int64)
        out = np.zeros_like(arr)
        stride = plan.row_stride
        stage_bytes = plan.rows_per_stage * stride
        ring_base = cu.ring_offset(c, plan.tile_cols)
        assert ring_base % 128 == 0 and stride % 16 == 0
        for lo, hi in cu.block_ranges(p, plan.granule, plan.blocks):
            ring = bytearray(plan.stages * stage_bytes)
            fresh = np.zeros(plan.stages * stage_bytes, dtype=bool)
            stage = 0
            for t0 in range(lo, hi, plan.tile_cols):
                t1 = min(t0 + plan.tile_cols, hi)
                for r0 in range(0, c, plan.rows_per_stage):
                    slot = stage % plan.stages
                    sb = slot * stage_bytes
                    fresh[sb:sb + stage_bytes] = False  # what this fill writes
                    rows = range(r0, min(r0 + plan.rows_per_stage, c))
                    for rr, r in enumerate(rows):  # producer
                        a = self.t0 + (r * p + t0) * eb
                        e = self.t0 + (r * p + t1) * eb
                        a0 = a // 16 * 16
                        s_lo, s_hi = max(a0, in0), min(-(-e // 16) * 16, in1)
                        d = sb + rr * stride
                        if s_hi > s_lo:  # one bulk copy
                            assert s_lo % 16 == 0 and (s_hi - s_lo) % 16 == 0
                            assert (ring_base + d + s_lo - a0) % 16 == 0
                            assert s_hi - a0 <= stride
                            ring[d + s_lo - a0:d + s_hi - a0] = self._read(s_lo, s_hi - s_lo)
                            fresh[d + s_lo - a0:d + s_hi - a0] = True
                        head_end = min(max(s_lo, a), e)
                        for x in [*range(a, head_end, eb),
                                  *range(max(s_hi, head_end), e, eb)]:  # fragments
                            assert x < in0 or x >= in1  # a partial end granule
                            ring[d + x - a0:d + x - a0 + eb] = self._read(x, eb)
                            fresh[d + x - a0:d + x - a0 + eb] = True
                            self.fragments += 1
                    # consumers: row r0 at its address mod 16, each next row
                    # (p * eb) mod 16 further
                    shift = (self.t0 + (r0 * p + t0) * eb) & 15
                    for rr, r in enumerate(rows):
                        assert shift == (self.t0 + (r * p + t0) * eb) & 15
                        d = sb + rr * stride + shift
                        n = t1 - t0
                        assert shift + n * eb <= stride
                        assert fresh[d:d + n * eb].all(), "read a byte this fill did not write"
                        out[r, t0:t1] = np.frombuffer(bytes(ring[d:d + n * eb]), arr.dtype)
                        read[r, t0:t1] += 1
                        shift = (shift + p * eb) & 15
                    stage += 1
        assert (read == 1).all(), "each element read exactly once"
        self.values = out

    def _read(self, addr, n):
        assert self.t0 <= addr and addr + n <= self.t1, "read outside the tensor"
        return self.raw[addr - self.t0:addr - self.t0 + n]


C, P, SEGS = 7, 3_002, (1_500, 2, 1_000, 500)  # P*4 = 8 mod 16, as at the slice
N_SMS = 2  # two blocks of 751-752 columns in one tile each; and one of 3,002 in three


def _plans(c, p, eb):
    real = cu.fedavg_plan(c, p, eb, N_SMS)
    one = cu.fedavg_plan(c, p, eb, 1)  # a block over several tiles
    # a small ring, refilled: 2 rows a stage, 2 stages
    small = one._replace(rows_per_stage=2, stages=2)
    return {"plan": real, "tiles": one, "small ring": small}


@functools.cache
def _inputs(c=C, p=P, seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        upd=rng.standard_normal((c, p)).astype(np.float32),
        base=rng.standard_normal(p).astype(np.float32),
        mask=rng.random(c) < 0.7,
        weights=(np.abs(rng.standard_normal(c)) * 100).astype(np.float32),
        noise=(0.1 * rng.standard_normal(p)).astype(np.float32),
        mu=rng.standard_normal(p).astype(np.float32),
        staleness=(np.arange(c) % 4).astype(np.float32),
        dm=(rng.random(c) < 0.7) * rng.uniform(0.5, 1.5, c).astype(np.float32),
    )


@functools.cache
def _jax_apply(gates=()):
    fx = _inputs()
    ref = jax_apply(jnp.asarray(fx["upd"]), jnp.asarray(fx["base"]), jnp.asarray(fx["mask"]),
                    jnp.asarray(fx["weights"]), lr=0.7, block_d=1024, interpret=True,
                    **_gate_kwargs(gates, jnp.asarray))
    return [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]


def _gate_kwargs(gates, conv):
    fx = _inputs()
    kw = dict(clip_norm=1.5 if "clip" in gates else 0.0,
              compression=next((g for g in gates if g in ("int8", "topk")), "none"),
              topk_fraction=0.1, staleness_exponent=0.5, server_momentum=0.9)
    kw["seg_sizes"] = SEGS if kw["compression"] != "none" else None
    if "stale" in gates:
        kw["staleness"] = conv(fx["staleness"])
    if "dp" in gates:
        kw["dp_noise"] = conv(fx["noise"])
    opt = next((g for g in gates if g in ("fedavgm", "fedadam")), None)
    if opt:
        kw["momentum"] = conv(fx["mu"])
        kw["server_optimizer"] = opt
    return kw


def _k3_emulated(gates, offset, plan_name):
    fx = _inputs()
    em = Emulated(fx["upd"], offset, _plans(C, P, 4)[plan_name])
    x = em.values
    assert np.array_equal(x, fx["upd"])
    assert em.fragments > 0  # C*P*4 = 8 mod 16: the tensor's end is partial
    tkw = _gate_kwargs(gates, torch.from_numpy)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in fx.items()}
    rows = cu.pipeline_rows(
        t["upd"], t["mask"], t["weights"], tkw.get("staleness"), 0.5, 0.1,
        clip_norm=tkw["clip_norm"], compression=tkw["compression"], topk_fraction=0.1,
        seg_sizes=tkw["seg_sizes"], aggregator="fedavg", sq_norms=delta_sq_norms_ref)
    out = kernel_model(torch.from_numpy(x), t["base"], rows, tkw.get("dp_noise"),
                       tkw.get("momentum"), lr=0.7, server_momentum=0.9,
                       compression=tkw["compression"], aggregator="fedavg",
                       server_optimizer=tkw.get("server_optimizer", "fedavg"))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("plan_name", ["plan", "tiles", "small ring"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_k3_reads_are_bitwise_the_jax_kernel_with_gates_off(offset, plan_name):
    (got,) = _k3_emulated((), offset, plan_name)
    (want,) = _jax_apply(())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gates", [("dp",), ("clip", "int8", "stale", "fedavgm"),
                                   ("clip", "topk", "dp", "fedadam")], ids=str)
def test_k3_reads_with_gates_on_match_the_jax_kernel(gates):
    got = _k3_emulated(gates, 1, "small ring")
    want = _jax_apply(gates)
    assert len(got) == len(want)
    atol = 5e-3 if "fedadam" in gates else 1e-6
    for o, r in zip(got, want):
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_k4_reads_are_bitwise_the_jax_kernel(offset):
    fx = _inputs()
    c4 = 5  # an odd fog block: the tensor's end is misaligned too
    upd = np.ascontiguousarray(fx["upd"][:c4])
    dm = fx["dm"][:c4]
    x = Emulated(upd, offset, _plans(c4, P, 4)["small ring"]).values
    out = kernel_model(torch.from_numpy(x), torch.zeros(P), (torch.from_numpy(dm), None,
                       None, None, None), None, None, lr=1.0, server_momentum=0.9,
                       compression="none", aggregator="fedavg", server_optimizer="fedavg")
    want = np.asarray(jax_partial(jnp.asarray(upd), jnp.asarray(dm), block_d=1024,
                                  interpret=True))
    np.testing.assert_array_equal(out.numpy(), want)


K1_DTYPES = [("float32", o) for o in range(4)] + [("bfloat16", o) for o in range(8)]


@pytest.mark.parametrize("dtype,offset", K1_DTYPES, ids=str)
def test_k1_reads_match_the_jax_reference(dtype, offset):
    """K1: the read values, the weight row lr·m·w/(Σm·w+1e-12), clients in
    order one FMA each, then one rounding of base + sum to the dtype. D =
    4,999 (odd, so bf16 rows shift by 2 bytes a row)."""
    fx = _inputs(8, 4_999, seed=5)
    tdt = getattr(torch, dtype)
    upd_t = torch.from_numpy(fx["upd"]).to(tdt)
    base_t = torch.from_numpy(fx["base"]).to(tdt)
    raw = upd_t.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy()
    for name, plan in _plans(8, 4_999, upd_t.element_size()).items():
        got_raw = Emulated(raw, offset, plan).values
        assert np.array_equal(got_raw, raw), name
    x = torch.from_numpy(got_raw).view(tdt).to(torch.float32)
    wn = weight_row(torch.from_numpy(fx["mask"]), torch.from_numpy(fx["weights"]), 0.9)
    agg = torch.zeros(4_999)
    for i in range(8):
        agg = _fma(wn[i], x[i], agg)
    out = _fma(1.0, agg, base_t.to(torch.float32)).to(tdt)
    want = jax_fedavg_ref(jnp.asarray(upd_t.float().numpy()).astype(dtype),
                          jnp.asarray(base_t.float().numpy()).astype(dtype),
                          jnp.asarray(fx["mask"]), jnp.asarray(fx["weights"]), lr=0.9)
    tol = 5e-2 if dtype == "bfloat16" else 2e-6
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=tol)
