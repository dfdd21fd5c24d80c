"""The port's delta-pipeline family (K2 ``delta_sq_norms``, K3
``delta_pipeline_apply``) against the JAX kernels run in interpret mode.

On the CPU the port runs the kernels' plain versions; the gate matrix
(``_pipeline_gates``) also holds a torch model of the CUDA kernel's
arithmetic against the JAX kernel. This file runs the half of the quick
matrix without DP noise and the full-scale subset;
``test_torch_delta_pipeline_dp.py`` runs the half with DP noise (the two
halves are separate files so each stays well under a minute on one core).
The CUDA kernels themselves run only on a card: ``test_kernels_on_card``
carries the ``cuda`` marker and ``chip_smoke.py`` holds them against the
plain versions at the simulator's shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _pipeline_gates import FULL_GATES, GATES, check_gate, fixture, kernel_model, to_torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.core.aggregation import median_aggregate, trimmed_mean_aggregate
from repro.kernels.delta_pipeline import delta_pipeline_apply as jax_apply
from repro.kernels.delta_pipeline import delta_sq_norms as jax_sq_norms
from repro.kernels.delta_pipeline import segment_table as jax_segment_table
from repro_torch.kernels.delta_pipeline import (
    delta_pipeline_apply,
    delta_pipeline_partial,
    delta_pipeline_partial_ref,
    delta_pipeline_ref,
    delta_sq_norms,
    segment_table,
)
from repro_torch.kernels.delta_pipeline import delta_pipeline as cu
from repro_torch.kernels.delta_pipeline.ref import delta_sq_norms_ref


@pytest.mark.parametrize(
    "dp,opt,comp,clip,stale", [g for g in GATES if not g[0]], ids=str
)
def test_gate_matrix_quick(dp, opt, comp, clip, stale):
    check_gate("quick", dp, opt, comp, clip, stale)


@pytest.mark.parametrize("dp,opt,comp,clip,stale", FULL_GATES, ids=str)
def test_gate_matrix_full(dp, opt, comp, clip, stale):
    check_gate("full", dp, opt, comp, clip, stale)


@pytest.mark.parametrize("c,p", [(8, 1000), (32, 13574)])
def test_sq_norms_match_jax(c, p):
    fx = fixture(c, p)
    out = delta_sq_norms(to_torch(fx)["upd"])
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_sq_norms(fx["upd"], block_d=256)), rtol=1e-6
    )


def _robust_ref(upd, base, mask, lr, frac, agg):
    a = median_aggregate(upd, mask) if agg == "median" else trimmed_mean_aggregate(
        upd, mask, frac)
    return base + lr * a


@pytest.mark.parametrize("c", [5, 6])
@pytest.mark.parametrize("mask_kind", ["random", "all", "alternating", "none"])
@pytest.mark.parametrize("agg,frac", [("median", 0.0), ("trimmed", 0.1),
                                      ("trimmed", 0.25)], ids=str)
def test_robust_aggregators_match_jax(agg, frac, mask_kind, c):
    """Median: bitwise against the JAX kernel's contract (its bitwise
    equal, ``core.aggregation.median_aggregate``). Trimmed mean: against
    ``core.aggregation.trimmed_mean_aggregate`` to rtol=1e-5, because the
    JAX kernel's own trimmed mean is not bitwise equal to it (ROADMAP R1).
    ``none`` (no client selected) gives +inf for the median and the
    unchanged base for the trimmed mean, as the JAX package does."""
    fx = fixture(c, 192)
    mask = {
        "random": fx["mask"], "all": jnp.ones((c,), bool),
        "alternating": jnp.arange(c) % 2 == 0, "none": jnp.zeros((c,), bool),
    }[mask_kind]
    exp = np.asarray(jax.jit(_robust_ref, static_argnames="agg")(
        fx["upd"], fx["base"], mask, 0.7, frac, agg=agg))
    tx = to_torch(fx)
    tmask = torch.from_numpy(np.array(mask))
    out = delta_pipeline_apply(tx["upd"], tx["base"], tmask, tx["weights"], 0.7,
                               trim_fraction=frac, aggregator=agg)
    rows = cu.pipeline_rows(tx["upd"], tmask, tx["weights"], None, 0.0, frac,
                            clip_norm=0.0, compression="none", topk_fraction=0.05,
                            seg_sizes=None, aggregator=agg)
    model = kernel_model(tx["upd"], tx["base"], rows, None, None, lr=0.7,
                         server_momentum=0.9, compression="none", aggregator=agg,
                         server_optimizer="fedavg")
    for got in (out, model):
        if agg == "median":
            np.testing.assert_array_equal(got.numpy(), exp)
        else:
            np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-6)
    if agg == "median" and mask_kind != "none":
        jout = jax_apply(fx["upd"], fx["base"], mask, fx["weights"], 0.7, None, 0.0,
                         None, None, frac, aggregator=agg, block_d=64)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("comp", ["int8", "topk"])
@pytest.mark.parametrize("with_pre", [False, True])
def test_segment_table_matches_jax(comp, with_pre):
    fx = fixture(6, 128)
    seg_sizes = (40, 8, 64, 16)
    pre = jnp.linspace(0.2, 1.0, 6) if with_pre else None
    ref = jax_segment_table(fx["upd"], comp, 0.1, seg_sizes,
                            pre=pre)
    out = segment_table(to_torch(fx)["upd"], comp, 0.1, seg_sizes,
                        pre=None if pre is None else torch.from_numpy(np.array(pre)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_weights_row_matches_jax_wrapper():
    """The Eq. 6 row K3 reads (staleness discount and damping folded in)
    against the JAX wrapper's expression."""
    fx = fixture(6, 16)
    s = jnp.maximum(fx["staleness"], 0.0)
    m = fx["mask"].astype(jnp.float32) * fx["weights"]
    dm = m * (1.0 + s) ** -0.5
    wn = dm / (jnp.sum(dm) + 1e-12) * ((jnp.sum(dm) + 1e-12) / (jnp.sum(m) + 1e-12))
    tx = to_torch(fx)
    rows = cu.pipeline_rows(tx["upd"], tx["mask"], tx["weights"], tx["staleness"], 0.5,
                            0.1, clip_norm=1.5, compression="none", topk_fraction=0.1,
                            seg_sizes=None, aggregator="fedavg",
                            sq_norms=delta_sq_norms_ref)
    np.testing.assert_allclose(rows[0].numpy(), np.asarray(wn), rtol=1e-6)
    norm = jnp.sqrt(jnp.sum(fx["upd"] ** 2, axis=1))
    pre = jnp.minimum(1.0, 1.5 / jnp.maximum(norm, 1e-12))
    np.testing.assert_allclose(rows[2].numpy(), np.asarray(pre), rtol=1e-6)
    assert rows[1] is None and rows[3] is None and rows[4] is None


def test_argument_checks_and_dispatch():
    tx = to_torch(fixture(4, 32))
    args = (tx["upd"], tx["base"], tx["mask"], tx["weights"])
    with pytest.raises(ValueError, match="compression"):
        delta_pipeline_apply(*args, compression="fp4")
    with pytest.raises(ValueError, match="seg_sizes"):
        delta_pipeline_apply(*args, compression="int8")
    with pytest.raises(ValueError, match="unweighted"):
        delta_pipeline_apply(*args, staleness=tx["staleness"], aggregator="median")
    with pytest.raises(ValueError, match="aggregator"):
        delta_pipeline_ref(*args, aggregator="krum")
    # the CUDA wrappers take CUDA tensors only (no silent CPU path)
    with pytest.raises(ValueError, match="CUDA"):
        cu.delta_pipeline_apply_cuda(*args)
    with pytest.raises(ValueError, match="CUDA"):
        cu.delta_sq_norms_cuda(tx["upd"])
    with pytest.raises(ValueError, match="device"):
        delta_sq_norms(tx["upd"].to("meta"))
    assert isinstance(cu.launch_pipeline.launches, int)
    assert isinstance(cu.delta_sq_norms_cuda.launches, int)


@pytest.mark.cuda
def test_kernels_on_card():
    """K2 and K3 on a CUDA card against their plain versions (the gate
    sets of chip_smoke.py, at a small ragged shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these kernels on the H100")
    dev = torch.device("cuda")
    fx = {k: v.to(dev) for k, v in to_torch(fixture(6, 130)).items()}
    segs = (41, 8, 64, 17)
    torch.testing.assert_close(delta_sq_norms(fx["upd"]), delta_sq_norms_ref(fx["upd"]),
                               rtol=1e-5, atol=1e-6)
    before = cu.launch_pipeline.launches
    for kw in (dict(), dict(dp_noise=fx["noise"]), dict(aggregator="median"),
               dict(aggregator="trimmed"),
               dict(clip_norm=1.5, compression="int8", seg_sizes=segs,
                    staleness=fx["staleness"], momentum=fx["mu"],
                    server_optimizer="fedavgm")):
        args = (fx["upd"], fx["base"], fx["mask"], fx["weights"])
        out = delta_pipeline_apply(*args, lr=0.7, **kw)
        ref = delta_pipeline_ref(*args, lr=0.7, **kw)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    assert cu.launch_pipeline.launches == before + 5
    # A contiguous view one element past a 16-byte boundary: every row and
    # both ends of the buffer are misaligned for the kernel's bulk copies.
    # With every gate off K3 and K4 equal their plain versions bit for bit.
    flat = torch.cat([torch.zeros(1, device=dev), fx["upd"].reshape(-1)])
    view = flat[1:].view(fx["upd"].shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    args = (view, fx["base"], fx["mask"], fx["weights"])
    assert torch.equal(delta_pipeline_apply(*args, lr=0.7), delta_pipeline_ref(*args, lr=0.7))
    out = delta_pipeline_apply(*args, lr=0.7, dp_noise=fx["noise"])
    ref = delta_pipeline_ref(*args, lr=0.7, dp_noise=fx["noise"])
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    dm = fx["mask"].float() * fx["weights"]
    assert torch.equal(delta_pipeline_partial(view, dm), delta_pipeline_partial_ref(view, dm))
    assert cu.launch_pipeline.launches == before + 7
