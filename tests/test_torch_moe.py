"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on numpy-seeded float32 inputs at the
reduced shapes of moonshot-v1-16b-a3b and mixtral-8x7b (d 64, d_ff 128,
4 experts top-2) and at wider expert counts.

Tolerance: rtol 1e-5 (float32; XLA and ATen order the products' sums
differently, a few ulps apart), atol 1e-6 for outputs near zero.
Dropped tokens of ``moe_ffn_gshard`` are held too: with a small capacity
factor the port drops exactly the assignments the JAX function drops.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.configs import get_reduced as jax_reduced
from repro.models import moe as jmoe
from repro_torch.configs import get_reduced
from repro_torch.models import moe as tmoe

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-6)
ARCHS = ["moonshot-v1-16b-a3b", "mixtral-8x7b"]


def _cfgs(arch, **over):
    return jax_reduced(arch, **F32, **over), get_reduced(arch, **F32, **over)


def _inputs(cfg, b=2, s=16, seed=0):
    """x (B, S, d) and the router / expert weights, as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.d_ff
    arrs = [rng.standard_normal((b, s, d)),
            rng.standard_normal((d, e)) / np.sqrt(d),
            rng.standard_normal((e, d, ff)) / np.sqrt(d),
            rng.standard_normal((e, d, ff)) / np.sqrt(d),
            rng.standard_normal((e, ff, d)) / np.sqrt(ff) / 2]
    arrs = [a.astype(np.float32) for a in arrs]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a.copy()) for a in arrs]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_topk_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    (jx, jw, *_), (tx, tw, *_) = _inputs(tcfg, s=32, seed=1)
    jp, ji = jmoe.router_topk(jx.reshape(-1, jcfg.d_model), jw, jcfg.experts_per_token)
    tp, ti = tmoe.router_topk(tx.reshape(-1, tcfg.d_model), tw, tcfg.experts_per_token)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(tp), np.asarray(jp), **TOL)
    np.testing.assert_allclose(_np(tp).sum(-1), 1.0, rtol=1e-6)


def test_router_ties_go_to_the_lower_expert_as_jax_breaks_them():
    """Duplicated router columns give exactly equal probabilities: both
    packages take the lower expert index first."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", num_experts=8, experts_per_token=3)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((24, tcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((tcfg.d_model, 4)).astype(np.float32)
    w = np.concatenate([w, w[:, ::-1]], axis=1)  # expert i ties with 7 - i
    jp, ji = jmoe.router_topk(jnp.asarray(x), jnp.asarray(w), 3)
    tp, ti = tmoe.router_topk(torch.from_numpy(x), torch.from_numpy(w.copy()), 3)
    probs = np.asarray(jax_softmax(x @ w))
    assert (np.abs(probs[:, :4] - probs[:, 7:3:-1]) == 0).all()  # the ties are exact
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_allclose(_np(tp), np.asarray(jp), **TOL)
    # every tied pair in the top 3 appears lower index first
    for row in _np(ti):
        for a, b in zip(row, row[1:]):
            assert not (a + b == 7 and a > b)


def jax_softmax(z):
    import jax

    return jax.nn.softmax(jnp.asarray(z), axis=-1)


@pytest.mark.parametrize("impl", ["reference", "dropless", "gshard"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, impl):
    jcfg, tcfg = _cfgs(arch)
    jargs, targs = _inputs(tcfg, seed=3)
    ref = getattr(jmoe, f"moe_ffn_{impl}")(*jargs, jcfg)
    got = getattr(tmoe, f"moe_ffn_{impl}")(*targs, tcfg)
    assert got.shape == tuple(ref.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["reference", "dropless"])
def test_moe_ffn_gelu_and_wide_experts_match_jax(impl):
    """GeGLU experts, 16 experts top-6 (moonshot's k), 96 tokens."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", num_experts=16, experts_per_token=6,
                       act="gelu")
    jargs, targs = _inputs(tcfg, b=3, s=32, seed=4)
    ref = getattr(jmoe, f"moe_ffn_{impl}")(*jargs, jcfg)
    got = getattr(tmoe, f"moe_ffn_{impl}")(*targs, tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("group_size", [16, 64])
def test_gshard_drops_the_tokens_jax_drops(group_size):
    """Capacity factor 0.25: 8 rows a group per expert against ~group/2
    assignments, so most assignments are dropped; the port drops the
    same ones (held through the output, which differs from the dropless
    result exactly where tokens lost an expert)."""
    jcfg, tcfg = _cfgs("mixtral-8x7b", moe_capacity_factor=0.25)
    jargs, targs = _inputs(tcfg, b=2, s=32, seed=5)
    ref = jmoe.moe_ffn_gshard(*jargs, jcfg, group_size=group_size)
    got = tmoe.moe_ffn_gshard(*targs, tcfg, group_size=group_size)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    full = _np(tmoe.moe_ffn_dropless(*targs, tcfg))
    dropped = np.abs(_np(got) - full).max(axis=-1) > 1e-4
    assert dropped.any() and not dropped.all()
    assert tmoe._capacity(group_size, 2, 4, 0.25) == jmoe._capacity(group_size, 2, 4, 0.25)


@pytest.mark.parametrize("capacity", [8, 24])
def test_local_dispatch_matches_jax(capacity):
    _, tcfg = _cfgs("mixtral-8x7b")
    rng = np.random.default_rng(6)
    xf = rng.standard_normal((20, tcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((tcfg.d_model, 4)).astype(np.float32)
    jp, ji = jmoe.router_topk(jnp.asarray(xf), jnp.asarray(w), 2)
    tp, ti = tmoe.router_topk(torch.from_numpy(xf), torch.from_numpy(w), 2)
    ref = jmoe._local_dispatch(jnp.asarray(xf), jp, ji, 4, capacity)
    got = tmoe._local_dispatch(torch.from_numpy(xf), tp, ti, 4, capacity)
    for name, g, r in zip(("buf", "sorted_e", "safe_pos", "weight", "tok", "keep"), got, ref):
        np.testing.assert_allclose(_np(g).astype(np.float64), np.asarray(r).astype(np.float64),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("experts,k,tokens", [(4, 2, 7), (64, 6, 8), (64, 6, 130), (8, 2, 1)])
def test_dropless_equals_reference_in_the_port(experts, k, tokens):
    """The served route drops nothing: equal to the all-experts oracle,
    also where one expert takes every token (a router that prefers it)."""
    _, tcfg = _cfgs("moonshot-v1-16b-a3b", num_experts=experts, experts_per_token=k)
    _, (x, w, wg, wu, wd) = _inputs(tcfg, b=1, s=tokens, seed=7)
    w = w.clone()
    w[:, 0] += 0.5 * x[0].mean(0) / x[0].mean(0).norm()  # crowd expert 0
    got = tmoe.moe_ffn_dropless(x, w, wg, wu, wd, tcfg)
    ref = tmoe.moe_ffn_reference(x, w, wg, wu, wd, tcfg)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


def test_mesh_paths_raise_naming_item_11():
    _, tcfg = _cfgs("mixtral-8x7b")
    _, targs = _inputs(tcfg)
    with pytest.raises(NotImplementedError, match="item 11"):
        tmoe.moe_ffn_ep(*targs, tcfg, object(), expert_axis="expert", tp_axis=None)
    with pytest.raises(NotImplementedError, match="item 11"):
        tmoe.moe_ffn_gshard(*targs, tcfg, mesh=object())
