"""repro_torch data, telemetry and delta-path helpers against the JAX package.

The port takes its random draws from a provider. Here the provider is
``tests/_jax_draws.JaxDraws``, which hands it the JAX package's own
``jax.random`` draws, so templates, priors, histograms, client and eval
batches and telemetry can be held against the JAX functions: labels,
permutations and masks exactly, floats to ``rtol=1e-6``, with an
absolute floor where a value can be near zero: ``atol=1e-7`` for the
AR(1) telemetry step, and ``atol=5e-7`` (about 4 float32 ulps at 1.0) for
templates and images, whose bilinear weights the two frameworks round
differently. The production provider (``repro_torch.random.TorchDraws``)
is checked for what it promises: keyed, reproducible blocks with the
right distributions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _jax_draws import JaxDraws
from _threads import one_thread  # noqa: F401 (autouse)

from repro.data import emnist_like as je
from repro.data import telemetry as jtel
from repro.fl import compression as jcomp
from repro.fl import fuse as jfuse
from repro.obs import history as jhist
from repro.optim import clip_by_global_norm as jclip
from repro_torch import tree
from repro_torch.data import emnist_like as te
from repro_torch.data import telemetry as ttel
from repro_torch.fl import compression as tcomp
from repro_torch.fl import fuse as tfuse
from repro_torch.obs import history as thist
from repro_torch.optim import clip_by_global_norm as tclip
from repro_torch.random import TorchDraws

N = 8


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=1e-6, atol=0.0):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind in "biu" or b.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# --------------------------------------------------------------------- #
# EMNIST-like task under the JAX package's draws
# --------------------------------------------------------------------- #
def test_templates_match_jax_resize():
    cfg = je.EmnistLikeConfig(seed=3)
    _close(te._templates(te.EmnistLikeConfig(seed=3), JaxDraws(3)),
           je._templates(cfg), atol=5e-7)


@pytest.mark.parametrize("drift_period,round_idx", [(0, 0), (0, 4), (2, 1), (2, 5)])
def test_priors_and_histograms_match_jax(drift_period, round_idx):
    jcfg = je.EmnistLikeConfig(seed=1, drift_period=drift_period, drift_fraction=0.5)
    tcfg = te.EmnistLikeConfig(seed=1, drift_period=drift_period, drift_fraction=0.5)
    draws = JaxDraws(1)
    r = jnp.int32(round_idx)
    cids = jnp.arange(N)
    _close(te.client_label_prior(tcfg, draws, N, round_idx),
           jax.vmap(lambda c: je.client_label_prior(jcfg, c, r))(cids))
    _close(te.client_histogram(tcfg, draws, N, round_idx),
           jax.vmap(lambda c: je.client_histogram(jcfg, c, r))(cids))
    if drift_period and round_idx // drift_period:
        epochs = jax.vmap(lambda c: je._drift_epoch(jcfg, c, r))(cids)
        _, flags = te._drift_epoch(tcfg, draws, N, round_idx)
        _close(flags, np.asarray(epochs) > 0)


@pytest.mark.parametrize("drift_period,round_idx", [(0, 1), (2, 4)])
def test_client_and_eval_batches_match_jax(drift_period, round_idx):
    jcfg = je.EmnistLikeConfig(seed=2, drift_period=drift_period, drift_fraction=0.5)
    tcfg = te.EmnistLikeConfig(seed=2, drift_period=drift_period, drift_fraction=0.5)
    draws = JaxDraws(2)
    batch = 12
    templates = te._templates(tcfg, draws)
    xt, yt = te.client_batch(tcfg, draws, N, round_idx, batch, templates)
    k_data = draws.round_key(round_idx, "data")
    xj, yj = jax.vmap(
        lambda c, k: je.client_batch(jcfg, c, jnp.int32(round_idx), k, batch)
    )(jnp.arange(N), jax.random.split(k_data, N))
    _close(yt, np.asarray(yj).astype(np.int64))
    _close(xt, xj, atol=5e-7)
    xe, ye = te.eval_batch(tcfg, draws, round_idx, 64, templates)
    xje, yje = je.eval_batch(jcfg, draws.round_key(round_idx, "eval"), 64)
    _close(ye, np.asarray(yje).astype(np.int64))
    _close(xe, xje, atol=5e-7)


def test_telemetry_matches_jax():
    jcfg = jtel.TelemetryConfig(num_clients=N, seed=4)
    tcfg = ttel.TelemetryConfig(num_clients=N, seed=4)
    draws = JaxDraws(4)
    pj, pt = jtel.make_profiles(jcfg), ttel.make_profiles(tcfg, draws)
    for f in ("mips", "bw_up", "bw_down", "rtt_ms", "battery_capacity_j"):
        _close(getattr(pt, f), getattr(pj, f))
    tj, tt = jtel.init_telemetry(jcfg), ttel.init_telemetry(tcfg, draws)
    for f in ("cpu", "mem", "batt", "energy"):
        _close(getattr(tt, f), getattr(tj, f))
    rng = np.random.default_rng(0)
    part = rng.random(N) < 0.5
    energy = (rng.random(N) * part * 2.0).astype(np.float32)
    for r in range(2):
        tj = jtel.step_telemetry(jcfg, tj, jnp.asarray(part), jnp.asarray(energy), pj,
                                 draws.round_key(r, "tel"))
        tt = ttel.step_telemetry(tcfg, tt, torch.from_numpy(part),
                                 torch.from_numpy(energy), pt, draws, round=r)
        for f in ("cpu", "mem", "batt", "energy"):
            _close(getattr(tt, f), getattr(tj, f), atol=1e-7)


# --------------------------------------------------------------------- #
# fused layout, compression, clipping, history
# --------------------------------------------------------------------- #
def _stacked(rng, c=5, sizes=((6, 4), (4, 3))):
    layers = []
    for a, b in sizes:
        layers.append({"w": rng.normal(size=(c, a, b)).astype(np.float32),
                       "b": rng.normal(size=(c, b)).astype(np.float32)})
    jt = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    tt = [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers]
    return jt, tt


def test_fuse_layout_is_flatten_order():
    jt, tt = _stacked(np.random.default_rng(0))
    cj, unj = jfuse.fuse_clients(jt)
    ct, unt = tfuse.fuse_clients(tt)
    _close(ct, cj)  # [b, w] per layer, as jax.tree.flatten sorts dict keys
    assert tfuse.stacked_leaf_sizes(tt) == jfuse.stacked_leaf_sizes(jt)
    _close(tfuse.segment_ids(tfuse.stacked_leaf_sizes(tt), "cpu"),
           jfuse.segment_ids(jfuse.stacked_leaf_sizes(jt)))
    back = unt(ct)
    for lt, l0 in zip(back, tt):
        for k in ("w", "b"):
            _close(lt[k], l0[k])
    single_j = [{k: v[0] for k, v in l.items()} for l in jt]
    single_t = [{k: v[0] for k, v in l.items()} for l in tt]
    vj, _ = jfuse.fuse_vector(single_j)
    vt, unv = tfuse.fuse_vector(single_t)
    _close(vt, vj)
    _close(unv(vt)[1]["w"], single_t[1]["w"])
    assert [tuple(x.shape) for x in tree.leaves(single_t)] == [
        tuple(x.shape) for x in jax.tree.leaves(single_j)]


def test_fused_dp_noise_matches_jax():
    sizes = (3, 24, 4, 12)
    shapes = [(3,), (6, 4), (4,), (4, 3)]
    draws = JaxDraws(6)
    ref = jfuse.fused_gaussian_noise(draws.round_key(2, "dp"), 0.7, sizes, shapes)
    _close(tfuse.fused_gaussian_noise(draws, 0.7, sizes, round=2), ref)


@pytest.mark.parametrize("kind", ["int8", "topk"])
@pytest.mark.parametrize("fused", [True, False])
def test_compression_matches_jax(kind, fused):
    jt, tt = _stacked(np.random.default_rng(1))
    out_j = jcomp.apply_compression(jt, kind, 0.2, fused=fused)
    out_t = tcomp.apply_compression(tt, kind, 0.2, fused=fused)
    for lj, lt in zip(out_j, out_t):
        for k in ("w", "b"):
            _close(lt[k], lj[k])
    for kind2 in ("none", "int8", "topk"):
        assert tcomp.wire_bytes_per_param(kind2) == jcomp.wire_bytes_per_param(kind2)
    assert tcomp.apply_compression(tt, "none") is tt
    with pytest.raises(ValueError):
        tcomp.apply_compression(tt, "fp4")


def test_clip_by_global_norm_matches_jax():
    jt, tt = _stacked(np.random.default_rng(2))
    out_j, norms_j = jax.vmap(lambda d: jclip(d, 2.0))(jt)
    out_t, norms_t = tclip(tt, 2.0, per_client=True)
    _close(norms_t, norms_j)
    for lj, lt in zip(out_j, out_t):
        for k in ("w", "b"):
            _close(lt[k], lj[k])
    one_j, n_j = jclip(jax.tree.map(lambda x: x[0], jt), 2.0)
    one_t, n_t = tclip(tree.map(lambda x: x[0], tt), 2.0)
    _close(n_t, n_j)
    _close(one_t[0]["w"], one_j[0]["w"])


def test_history_schema_matches_jax():
    hist = {
        "accuracy": [0.1, 0.5, 0.4], "energy_j": [1.0, 2.0, 0.5],
        "round_latency_ms": [10.0, 20.0, 30.0], "cold_starts": [3, 1, 0],
        "fault_retries": [0, 1, 0], "round_skipped": [0, 0, 1],
    }
    hj = jhist.finalize_history({k: list(v) for k, v in hist.items()}, rounds=3)
    ht = thist.finalize_history({k: list(v) for k, v in hist.items()}, rounds=3)
    assert ht == hj
    assert thist.summary_metrics(ht) == jhist.summary_metrics(hj)
    assert thist.finalize_history({}) == jhist.finalize_history({})


# --------------------------------------------------------------------- #
# the production provider
# --------------------------------------------------------------------- #
def test_production_draws_are_keyed_and_reproducible():
    a, b = TorchDraws(5, "cpu"), TorchDraws(5, "cpu")
    x = a.normal("client_batch.noise", (4, 3), round=2)
    assert torch.equal(x, b.normal("client_batch.noise", (4, 3), round=2))
    assert not torch.equal(x, a.normal("client_batch.noise", (4, 3), round=3))
    assert not torch.equal(x, TorchDraws(6, "cpu").normal(
        "client_batch.noise", (4, 3), round=2))
    # the prior of an epoch is the same block whenever it is asked for
    p0 = a.dirichlet("prior", 0.5, (6, 62), epoch=0)
    assert torch.equal(p0, b.dirichlet("prior", 0.5, (6, 62), epoch=0))
    assert not torch.equal(p0, a.dirichlet("prior", 0.5, (6, 62), epoch=1))
    perm = a.permutation("drift.perm", 62, epoch=1)
    assert sorted(perm.tolist()) == list(range(62))
    u = a.uniform("telemetry.init.cpu", (1000,), 0.4, 1.0)
    assert float(u.min()) >= 0.4 and float(u.max()) < 1.0


@pytest.mark.parametrize("alpha", [0.5, 2.0])
def test_production_dirichlet_moments(alpha):
    k, n = 4, 20000
    p = TorchDraws(0, "cpu").dirichlet("prior", alpha, (n, k), epoch=0)
    assert torch.allclose(p.sum(-1), torch.ones(n), atol=1e-5)
    a0 = alpha * k
    var = alpha * (a0 - alpha) / (a0 * a0 * (a0 + 1))
    # mean 1/k, variance alpha(a0-alpha)/(a0²(a0+1)); 5 standard errors
    np.testing.assert_allclose(_np(p.mean(0)), 1.0 / k, atol=5 * (var / n) ** 0.5)
    np.testing.assert_allclose(_np(p.var(0)), var, rtol=0.1)


def test_production_categorical_and_bernoulli_frequencies():
    d = TorchDraws(1, "cpu")
    probs = torch.tensor([[0.7, 0.2, 0.1], [0.1, 0.1, 0.8]])
    y = d.categorical("client_batch.labels", torch.log(probs), 20000, round=0)
    freq = torch.stack([(y == i).float().mean(1) for i in range(3)], 1)
    np.testing.assert_allclose(_np(freq), _np(probs), atol=0.015)
    flags = d.bernoulli("drift.flags", 0.3, (20000,), epoch=1)
    assert abs(float(flags.float().mean()) - 0.3) < 0.015
    z = d.normal("eval.noise", (20000,), round=1)
    assert abs(float(z.mean())) < 0.03 and abs(float(z.std()) - 1.0) < 0.03
