"""Shared inputs and checks of the ``robust_kernel`` design tests
(``tests/test_torch_robust_design*.py``, split by the client count C so
that no one file holds most of the run).

The card design of K3's median / trimmed-mean route (``robust_kernel``,
a sorting network over each column in registers) emulated on the CPU
(``_robust_network``) and held against the JAX package.

Inputs come from a numpy seed; a third of the columns are rounded to
halves, so they hold ties and signed zeros, and top-k emulation makes
more zeros of both signs. The rows the kernel reads (clip scales, the
compression table) are made by the JAX package's own functions, so the
emulated kernel and the JAX kernel transform the same values.

* Median: ``torch.equal`` (which counts -0.0 == +0.0: no sorting network
  orders signed zeros) against the JAX ``_select_aggregate`` through
  ``delta_pipeline_apply`` in interpret mode (at base 0 and lr 1, so its
  output is the median itself), and against
  ``core.aggregation.median_aggregate`` (JAX and port) on the transformed
  values.
* Trimmed mean: against ``core.aggregation.trimmed_mean_aggregate`` at
  rtol 1e-5, atol 1e-6; the JAX kernel's own trimmed mean is not bitwise
  equal to it (ROADMAP R1), so it is not the reference here.
* No client selected: median +inf and the trimmed mean's output the base,
  exactly.
* NaN deltas (one client's whole row, scattered entries of another): the
  network keeps every value and sorts NaN after +inf, as torch.sort and
  jnp.sort do, so the median equals ``core.aggregation``'s (JAX and port)
  NaN for NaN and the trimmed mean is held as above.
* The network itself: every 0/1 input of length N2 <= 16 comes out sorted
  (the zero-one principle), and its size at N2 = 64 is the 543
  compare-exchanges the kernel's comment states.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _async_parity import one_thread  # noqa: F401 (autouse, re-exported)
from _pipeline_gates import kernel_model, kernel_transform
from _robust_network import robust_aggregate

from repro.core import aggregation as jax_agg
from repro.kernels.delta_pipeline import delta_pipeline_apply as jax_apply
from repro.kernels.delta_pipeline import delta_sq_norms as jax_sq_norms
from repro.kernels.delta_pipeline import segment_table as jax_segment_table
from repro_torch.core import aggregation as torch_agg
from repro_torch.kernels.delta_pipeline.delta_pipeline import pipeline_rows
from repro_torch.kernels.delta_pipeline.ref import delta_sq_norms_ref

MASKS = ["random", "all", "alternating", "none", "one"]
AGGS = [("median", 0.0), ("trimmed", 0.1), ("trimmed", 0.25)]
GATES = ["none", "clip", "int8", "topk"]
SEGS = (40, 8, 64, 17)  # P = 129: two blocks of the JAX kernel, one ragged
P = sum(SEGS)
BLOCK_D = 128
CLIP, TOPK, LR = 1.5, 0.1, 0.7


def inputs(c: int, mask_kind: str):
    rng = np.random.default_rng(1000 + c)
    upd = rng.standard_normal((c, P)).astype(np.float32) * np.float32(0.5)
    upd[:, ::3] = np.round(upd[:, ::3] * 2) / 2  # ties and signed zeros
    base = rng.standard_normal(P).astype(np.float32)
    weights = (np.abs(rng.standard_normal(c)) * 100).astype(np.float32)
    mask = {
        "random": rng.random(c) < 0.7,
        "all": np.ones(c, bool),
        "alternating": np.arange(c) % 2 == 0,
        "none": np.zeros(c, bool),
        "one": np.arange(c) == c // 2,
    }[mask_kind]
    return upd, base, weights, mask


def gate_kwargs(gate: str) -> dict:
    return dict(
        clip_norm=CLIP if gate == "clip" else 0.0,
        compression=gate if gate in ("int8", "topk") else "none",
        topk_fraction=TOPK,
        seg_sizes=SEGS if gate in ("int8", "topk") else None,
    )


@functools.partial(jax.jit, static_argnames="gate")
def _jax_rows(upd, gate):
    kw = gate_kwargs(gate)
    pre = tab = None
    if kw["clip_norm"] > 0:
        norm = jnp.sqrt(jax_sq_norms(upd, block_d=min(BLOCK_D, P)))
        pre = jnp.minimum(1.0, kw["clip_norm"] / jnp.maximum(norm, 1e-12))
    if kw["compression"] != "none":
        tab = jax_segment_table(upd, kw["compression"], TOPK, SEGS, pre=pre)
    return pre, tab


def jax_rows(upd, gate: str):
    """The clip scales, leaf ids and compression table as the JAX wrapper
    makes them, under jit as it does (XLA rewrites the table's division by
    127 there), as torch tensors (None where the gate is off)."""
    pre, tab = (None if a is None else torch.from_numpy(np.array(a))
                for a in _jax_rows(jnp.asarray(upd), gate))
    seg = None
    if tab is not None:
        seg = torch.from_numpy(np.repeat(np.arange(len(SEGS)), SEGS).astype(np.int32))
    return pre, seg, tab


def network_matches_jax(c, mask_kind, agg, frac, gate):
    upd, base, weights, mask = inputs(c, mask_kind)
    tu, tb, tm = (torch.from_numpy(a) for a in (upd, base, mask))
    wn, cnt = pipeline_rows(tu, tm, torch.from_numpy(weights), None, 0.0, frac,
                            clip_norm=0.0, compression="none", topk_fraction=TOPK,
                            seg_sizes=None, aggregator=agg)[:2]
    pre, seg, tab = jax_rows(upd, gate)
    kw = gate_kwargs(gate)
    out = kernel_model(tu, tb, (wn, cnt, pre, seg, tab), None, None, lr=LR,
                       server_momentum=0.9, compression=kw["compression"],
                       aggregator=agg, server_optimizer="fedavg")
    x = kernel_transform(tu, pre, seg, tab, kw["compression"])
    num_sel, k_trim = (int(v) for v in cnt)
    assert num_sel == int(mask.sum()) and k_trim == int(np.floor(
        np.float32(num_sel) * np.float32(frac)))
    got = robust_aggregate(x, tm, num_sel, k_trim, agg)
    assert got.dtype == torch.float32 and got.shape == (P,)
    if agg == "median":
        # The JAX kernel's median itself: its output at base 0 and lr 1
        # (whether XLA fuses its base + lr * agg into one FMA varies).
        jout = jax_apply(jnp.asarray(upd), jnp.zeros(P), jnp.asarray(mask),
                         jnp.asarray(weights), 1.0, trim_fraction=frac,
                         aggregator="median", block_d=BLOCK_D, **kw)
        assert torch.equal(got, torch.from_numpy(np.array(jout)))
        assert torch.equal(got, torch_agg.median_aggregate(x, tm))
        assert torch.equal(got, torch.from_numpy(np.array(
            jax_agg.median_aggregate(jnp.asarray(x.numpy()), jnp.asarray(mask)))))
        if mask_kind == "none":
            assert bool(torch.isinf(out).all() and (out > 0).all())
    else:
        ref = np.array(jax_agg.trimmed_mean_aggregate(
            jnp.asarray(x.numpy()), jnp.asarray(mask), frac))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            got.numpy(), torch_agg.trimmed_mean_aggregate(x, tm, frac).numpy(),
            rtol=1e-5, atol=1e-6)
        if mask_kind == "none":
            assert torch.equal(out, tb)


def nan_inputs(c: int, mask_kind: str):
    """``inputs`` with client c // 2 selected and its whole delta NaN, and
    every seventh entry of the next client's delta NaN."""
    upd, base, weights, mask = inputs(c, mask_kind)
    mask[c // 2] = True
    upd[c // 2] = np.nan
    upd[(c // 2 + 1) % c, ::7] = np.nan
    return upd, base, weights, mask


def same_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values (-0.0 == +0.0) and NaN where the other has NaN."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def network_keeps_nan(c, mask_kind, agg, frac, gate):
    upd, base, weights, mask = nan_inputs(c, mask_kind)
    tu, tm = torch.from_numpy(upd), torch.from_numpy(mask)
    kw = gate_kwargs(gate)
    wn, cnt, pre, seg, tab = pipeline_rows(
        tu, tm, torch.from_numpy(weights), None, 0.0, frac, aggregator=agg,
        sq_norms=delta_sq_norms_ref, **kw)
    x = kernel_transform(tu, pre, seg, tab, kw["compression"])
    num_sel, k_trim = (int(v) for v in cnt)
    got = robust_aggregate(x, tm, num_sel, k_trim, agg)
    if agg == "median":
        assert same_nan(got, torch_agg.median_aggregate(x, tm))
        assert same_nan(got, torch.from_numpy(np.array(
            jax_agg.median_aggregate(jnp.asarray(x.numpy()), jnp.asarray(mask)))))
    else:
        ref = np.array(jax_agg.trimmed_mean_aggregate(
            jnp.asarray(x.numpy()), jnp.asarray(mask), frac))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            got.numpy(), torch_agg.trimmed_mean_aggregate(x, tm, frac).numpy(),
            rtol=1e-5, atol=1e-6)
