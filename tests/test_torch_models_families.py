"""The five configurations of the MoE family and the wider dense family
(qwen2.5-14b, yi-9b, gemma3-12b, moonshot-v1-16b-a3b, mixtral-8x7b)
against the JAX package, at ``reduced()`` size in float32 with the JAX
parameters carried across by ``convert.model_params_from_jax``: prefill
logits and cache, three decode steps and ``Model.loss``. The JAX model
runs with ``scan_layers=False`` (ROADMAP.md R5). At full size the
parameter counts are read from the declarations of both packages,
without allocating.

Tolerance ``MODEL_TOL`` (2e-5 absolute + 1e-4 relative), as for
llama3.2-1b in ``test_torch_models.py``: XLA and ATen order their sums
differently, carried through two layers and the LM head.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import Family, build_model

F32 = dict(param_dtype="float32", compute_dtype="float32", scan_layers=False)
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)
ARCHS = ["qwen2.5-14b", "yi-9b", "gemma3-12b", "moonshot-v1-16b-a3b", "mixtral-8x7b"]
# (arch, overrides): each config reduced, gemma3 also with a local layer
# of window 4 before a global one (both RoPE thetas, the window inside
# the prompt), and mixtral through the chunked attention path
CASES = [(a, {}) for a in ARCHS] + [
    ("gemma3-12b", dict(window_pattern=(4, -1))),
    ("mixtral-8x7b", dict(window_pattern=(5,), attn_impl="xla_chunked", attn_chunk_q=4,
                          attn_chunk_kv=3)),
]
# full-size parameter counts (ROADMAP.md's table; read from the JAX
# package's declarations)
FULL_PARAMS = {"qwen2.5-14b": 14_770_033_664, "yi-9b": 8_829_407_232,
               "gemma3-12b": 11_765_419_776, "moonshot-v1-16b-a3b": 28_057_995_264,
               "mixtral-8x7b": 46_702_792_704}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _models(arch, **over):
    jcfg = jax_reduced(arch, **F32, **over)
    tcfg = get_reduced(arch, **F32, **over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


def _case_id(case):
    arch, over = case
    return arch + ("-" + "-".join(f"{k}={v}" for k, v in over.items()) if over else "")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_prefill_decode_and_loss_match_jax(case):
    arch, over = case
    jcfg, jm, jp, tcfg, tm, tp = _models(arch, **over)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 256, (2, 7)).astype(np.int32)
    jl_, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, cache_len=12)
    with torch.no_grad():
        tl_, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, cache_len=12)
    np.testing.assert_allclose(_np(tl_), np.asarray(jl_), **MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), **MODEL_TOL)
    tok = np.argmax(np.asarray(jl_)[:, -1], axis=-1).astype(np.int32)[:, None]
    for _ in range(3):
        jl_, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        with torch.no_grad():
            tl_, tc = tm.decode_step(tp, tc, torch.from_numpy(tok).long())
        np.testing.assert_allclose(_np(tl_), np.asarray(jl_), **MODEL_TOL)
        np.testing.assert_allclose(_np(tc["v"]), np.asarray(jc["v"]), **MODEL_TOL)
        tok = np.argmax(np.asarray(jl_)[:, -1], axis=-1).astype(np.int32)[:, None]
    assert tc["pos"] == int(jc["pos"]) == 10
    batch = rng.integers(0, 256, (2, 9)).astype(np.int32)
    ref = jm.loss(jp, {"tokens": jnp.asarray(batch)})
    with torch.no_grad():
        got = tm.loss(tp, {"tokens": torch.from_numpy(batch)})
    np.testing.assert_allclose(float(got), float(ref), **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_counts_and_config_match_jax(arch):
    tc, jc = get_config(arch), jax_config(arch)
    for f in dataclasses.fields(jc):
        tv, jv = getattr(tc, f.name), getattr(jc, f.name)
        assert (tv.value == jv.value) if f.name == "family" else tv == jv, f.name
    tm, jm = build_model(tc), jax_build(jc)
    assert tm.param_count() == jm.param_count() == FULL_PARAMS[arch]
    assert tm.active_param_count() == jm.active_param_count()
    assert tm.flops_per_token(train=False) == jm.flops_per_token(train=False)
    if tc.num_experts:
        assert tc.family is Family.MOE and tm.active_param_count() < tm.param_count()
    else:
        assert tm.active_param_count() == tm.param_count()


@pytest.mark.parametrize("arch", ["gemma3-12b", "moonshot-v1-16b-a3b"])
def test_weights_carry_across_leaf_for_leaf(arch):
    """Every leaf of the JAX tree lands in the port's tree at its shape
    and values; the MoE leaves replace the dense MLP's."""
    jcfg, jm, jp, tcfg, tm, tp = _models(arch)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == sum(1 for _ in _leaves(tp))
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(_np(node), np.asarray(leaf))
    layers = tp["layers"]
    moe = {"w_router", "we_gate", "we_up", "we_down"}
    dense = {"w_gate", "w_up", "w_down"}
    assert (moe <= set(layers) and not dense & set(layers)) if tcfg.num_experts else \
        (dense <= set(layers) and not moe & set(layers))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("impl", ["reference", "gshard"])
def test_moe_runtime_routes_match_the_served_route(impl):
    """``Runtime.moe_impl`` picks the FFN: the reference and (at a capacity
    that drops nothing) gshard give the dropless prefill's logits."""
    from repro_torch.models import Runtime

    *_, tcfg, tm, tp = _models("moonshot-v1-16b-a3b", moe_capacity_factor=4.0)
    prompt = torch.from_numpy(np.random.default_rng(12).integers(0, 256, (1, 8)))
    with torch.no_grad():
        ref, _ = tm.prefill(tp, {"tokens": prompt}, cache_len=8)
        got, _ = tm.prefill(tp, {"tokens": prompt}, cache_len=8, runtime=Runtime(moe_impl=impl))
    np.testing.assert_allclose(_np(got), _np(ref), **MODEL_TOL)
    with pytest.raises(NotImplementedError, match="item 11"):
        tm.prefill(tp, {"tokens": prompt}, cache_len=8, runtime=Runtime(moe_impl="ep"))
