"""The port's fog tier against the JAX package: K4 (``delta_pipeline_partial``),
the cloud epilogue (``combine_epilogue``) and ``fl/fog.py``'s reductions.

K4's plain version is held against the JAX kernel run in interpret mode,
and so is a torch model of the CUDA kernel's arithmetic on the rows its
wrapper prepares (``gate_rows``), as ``_pipeline_gates`` does for K3:

  * bitwise with every gate off: both sum the clients in order with one
    float32 FMA each, as XLA's CPU dot does;
  * with clip or compression on, to ``rtol=1e-5, atol=1e-6`` AFTER the
    cloud's normalisation by Σdm: K4's output is unnormalized (terms of
    size dm·x), and ``_pipeline_gates``' tolerance is stated for outputs
    of unit scale. The clip scales differ by rounding (Σx² is reduced in
    another order), which moves every term by an ulp.

Three population rounds with two fogs are held against the JAX
simulator through ``check_three_rounds`` (its tolerances are stated in
``test_torch_simulator.py``).

The epilogue runs the same float32 operations one by one as the JAX
function run eagerly, so it is held bitwise. The fog reductions are held
to ``rtol=1e-5, atol=1e-6`` (the JAX package's own tolerance for them in
``tests/test_fog_population.py``): per-fog scalar sums reduce in another
order in XLA and in torch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _pipeline_gates import fixture, kernel_model, to_torch
from _threads import one_thread  # noqa: F401 (autouse)
from test_torch_simulator import check_three_rounds

from repro.core.aggregation import fedavg_stacked as jax_fedavg_stacked
from repro.fl import fog as jfog
from repro.kernels.delta_pipeline import delta_pipeline_partial as jax_partial
from repro.kernels.delta_pipeline.sharded import combine_epilogue as jax_epilogue
from repro_torch.core.aggregation import fedavg_stacked
from repro_torch.fl import fog as tfog
from repro_torch.kernels.delta_pipeline import (
    delta_pipeline_partial,
    delta_pipeline_partial_ref,
)
from repro_torch.kernels.delta_pipeline import delta_pipeline as cu
from repro_torch.kernels.delta_pipeline.ref import delta_sq_norms_ref
from repro_torch.kernels.delta_pipeline.sharded import combine_epilogue

SEGS = (41, 8, 64, 17, 70)  # P = 200: a ragged tail for block_d = 64


def _k4_inputs(c, seed=0):
    fx = fixture(c, sum(SEGS))
    rng = np.random.default_rng(seed)
    mask = np.asarray(fx["mask"])
    dm = (mask * rng.uniform(0.5, 1.5, c)).astype(np.float32)
    return fx, jnp.asarray(dm), torch.from_numpy(dm)


@pytest.mark.parametrize("c", [4, 16])
@pytest.mark.parametrize("comp", ["none", "int8", "topk"])
@pytest.mark.parametrize("clip", [0.0, 1.5])
def test_partial_matches_jax_kernel(c, comp, clip):
    fx, dm_j, dm_t = _k4_inputs(c)
    kw = dict(clip_norm=clip, compression=comp, topk_fraction=0.1,
              seg_sizes=SEGS if comp != "none" else None)
    ref = np.asarray(jax_partial(fx["upd"], dm_j, block_d=64, interpret=True, **kw))
    upd = to_torch(fx)["upd"]
    plain = delta_pipeline_partial(upd, dm_t, **kw)
    rows = cu.gate_rows(upd, clip, comp, 0.1, kw["seg_sizes"], delta_sq_norms_ref)
    model = kernel_model(upd, torch.zeros(upd.shape[1]), (dm_t, None) + rows, None,
                         None, lr=1.0, server_momentum=0.9, compression=comp,
                         aggregator="fedavg", server_optimizer="fedavg")
    scale = float(dm_t.sum())
    for got in (plain, model):
        if comp == "none" and clip == 0.0:
            np.testing.assert_array_equal(got.numpy(), ref)
        else:
            np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                                       rtol=1e-5, atol=1e-6)


def test_partial_checks_and_dispatch():
    fx, _, dm_t = _k4_inputs(4)
    upd = to_torch(fx)["upd"]
    with pytest.raises(ValueError, match="seg_sizes"):
        delta_pipeline_partial(upd, dm_t, compression="int8")
    with pytest.raises(ValueError, match="compression"):
        delta_pipeline_partial_ref(upd, dm_t, compression="fp4", seg_sizes=SEGS)
    # the CUDA wrapper takes CUDA tensors only (no silent CPU path)
    with pytest.raises(ValueError, match="CUDA"):
        cu.delta_pipeline_partial_cuda(upd, dm_t)
    with pytest.raises(ValueError, match="device"):
        delta_pipeline_partial(upd.to("meta"), dm_t.to("meta"))
    assert isinstance(cu.launch_partial.launches, int)


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("dp", [False, True])
@pytest.mark.parametrize("opt", ["fedavg", "fedavgm", "fedadam"])
def test_combine_epilogue_matches_jax(stale, dp, opt):
    fx = fixture(3, 96)
    agg_sum = fx["upd"][0] * 40.0
    sdm, sm = jnp.float32(31.5), jnp.float32(44.25)
    kw = dict(has_stale=stale, dp_noise=fx["noise"] if dp else None,
              momentum=fx["mu"] if opt != "fedavg" else None,
              server_optimizer=opt, server_momentum=0.9)
    ref = jax_epilogue(agg_sum, sdm, sm, fx["base"], jnp.float32(0.7), **kw)
    tx = to_torch(fx)
    tkw = dict(kw, dp_noise=tx["noise"] if dp else None,
               momentum=tx["mu"] if opt != "fedavg" else None)
    got = combine_epilogue(torch.from_numpy(np.array(agg_sum)), torch.tensor(31.5),
                           torch.tensor(44.25), tx["base"], torch.tensor(0.7), **tkw)
    assert (got[1] is None) == (ref[1] is None)
    for g, r in zip(got, ref):
        if r is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _fog_inputs(c, p, seed):
    rng = np.random.default_rng(seed)
    upd = rng.normal(size=(c, p)).astype(np.float32)
    mask = rng.random(c) < 0.7
    w = rng.integers(5, 80, c).astype(np.float32)
    stale = rng.integers(0, 5, c).astype(np.float32)
    return upd, mask, w, stale


@pytest.mark.parametrize("fog_nodes", [1, 2, 4, 8])
@pytest.mark.parametrize("stale", [False, True])
def test_fog_aggregate_matches_jax_and_flat(fog_nodes, stale):
    upd, mask, w, s = _fog_inputs(16, 33, 3)
    st_j, st_t = (jnp.asarray(s), torch.from_numpy(s)) if stale else (None, None)
    ref = jfog.fog_aggregate(jnp.asarray(upd), jnp.asarray(mask), jnp.asarray(w),
                             fog_nodes, st_j, 0.5)
    got = tfog.fog_aggregate(torch.from_numpy(upd), torch.from_numpy(mask),
                             torch.from_numpy(w), fog_nodes, st_t, 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    if not stale:
        flat = fedavg_stacked(torch.from_numpy(upd), torch.from_numpy(mask),
                              torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            flat.numpy(), np.asarray(jax_fedavg_stacked(
                jnp.asarray(upd), jnp.asarray(mask), jnp.asarray(w))),
            rtol=1e-5, atol=1e-6)


def test_fog_partials_under_a_permuted_assignment():
    """Any client -> fog assignment gives the flat Eq. 6 aggregate, and
    the partials equal the JAX package's ``segment_sum`` partials."""
    upd, mask, w, _ = _fog_inputs(12, 9, 5)
    assign = np.random.default_rng(0).permutation((np.arange(12) * 3) // 12)
    pj = jfog.fog_partial_sums(jnp.asarray(upd), jnp.asarray(mask), jnp.asarray(w), 3,
                               assignment=jnp.asarray(assign, jnp.int32))
    pt = tfog.fog_partial_sums(torch.from_numpy(upd), torch.from_numpy(mask),
                               torch.from_numpy(w), 3,
                               assignment=torch.from_numpy(assign))
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    got = tfog.cloud_combine(*pt, has_stale=False)
    flat = fedavg_stacked(torch.from_numpy(upd), torch.from_numpy(mask),
                          torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fog_nodes,gates", [
    (2, dict()),
    (4, dict(stale=True, dp=True, opt="fedavgm")),
    (2, dict(clip_norm=1.5, compression="int8")),
    (4, dict(compression="topk", opt="fedadam")),
], ids=["plain", "stale+dp+fedavgm", "clip+int8", "topk+fedadam"])
def test_fog_pipeline_apply_matches_jax(fog_nodes, gates):
    c = 8
    fx = fixture(c, sum(SEGS))
    opt = gates.get("opt", "fedavg")
    comp = gates.get("compression", "none")
    kw = dict(lr=0.7, staleness_exponent=0.5, fog_nodes=fog_nodes,
              clip_norm=gates.get("clip_norm", 0.0), compression=comp,
              topk_fraction=0.1, seg_sizes=SEGS if comp != "none" else None,
              server_optimizer=opt, server_momentum=0.9)
    opt_args = lambda f: dict(  # noqa: E731
        staleness=f["staleness"] if gates.get("stale") else None,
        dp_noise=f["noise"] if gates.get("dp") else None,
        momentum=f["mu"] if opt != "fedavg" else None)
    ref = jfog.fog_pipeline_apply(fx["upd"], fx["base"], fx["mask"], fx["weights"],
                                  block_d=64, interpret=True, **kw, **opt_args(fx))
    tx = to_torch(fx)
    got = tfog.fog_pipeline_apply(tx["upd"], tx["base"], tx["mask"], tx["weights"],
                                  **kw, **opt_args(tx))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    atol = 5e-3 if opt == "fedadam" else 1e-6  # _pipeline_gates' FedAdam allowance
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=atol)


def test_fog_pipeline_apply_equals_k3_at_one_fog():
    """One fog is the flat pipeline: the same weights, partial and apply
    as K3's plain version, to rounding (K3 normalizes the weights before
    its sum, the fog path after it)."""
    from repro_torch.kernels.delta_pipeline import delta_pipeline_apply

    tx = to_torch(fixture(8, 96))
    args = (tx["upd"], tx["base"], tx["mask"], tx["weights"])
    np.testing.assert_allclose(
        tfog.fog_pipeline_apply(*args, lr=0.7, fog_nodes=1).numpy(),
        delta_pipeline_apply(*args, lr=0.7).numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        tfog.fog_pipeline_apply(*args, fog_nodes=3)


@pytest.mark.parametrize("drift_period", [0, 2])
def test_three_fog_rounds_match_jax(drift_period):
    """Population 256, cohort 8, two fogs (one K4 pass each on the kernel
    path): three rounds against the JAX simulator through
    ``check_three_rounds``, with and without drift injection."""
    check_three_rounds(population=256, fog_nodes=2, drift_period=drift_period)


@pytest.mark.cuda
def test_partial_kernel_on_card():
    """K4 on a CUDA card against its plain version (chip_smoke.py holds
    it at the simulator's shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs K4 on the H100")
    fx, _, dm_t = _k4_inputs(16)
    upd, dm = to_torch(fx)["upd"].cuda(), dm_t.cuda()
    before = cu.launch_partial.launches
    for kw in (dict(), dict(clip_norm=1.5, compression="int8", seg_sizes=SEGS),
               dict(compression="topk", topk_fraction=0.1, seg_sizes=SEGS)):
        out = delta_pipeline_partial(upd, dm, **kw)
        ref = delta_pipeline_partial_ref(upd, dm, **kw)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert cu.launch_partial.launches == before + 3
