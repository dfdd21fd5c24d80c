"""The port's DENSE model (``repro_torch.models``) against the JAX
package's, on the reduced llama3.2-1b (2 layers, d 64, 4 heads, 2 kv
heads, hd 16, vocab 256) in float32, with the JAX parameters carried
across by ``convert.model_params_from_jax``. Inputs come from a numpy
seed and go through both packages.

Tolerances: the layers to 1e-5 (float32; XLA and ATen order their sums
and compute exp / cos / sin differently, a few ulps apart); whole-model
logits and caches to 2e-5 absolute + 1e-4 relative (those differences
carried through two layers and the tied LM head). The flash cases run
the JAX model with ``scan_layers=False``: under the default layer scan
the JAX flash wrapper calls ``int(window)`` on a tracer (ROADMAP.md R5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import build_model, layers as tl
from repro_torch.models import transformer as ttf

F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)
GLOBAL = -1


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _models(**over):
    jcfg = jax_reduced("llama3.2-1b", **F32, **over)
    tcfg = get_reduced("llama3.2-1b", **F32, **over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
def test_rms_norm_and_gated_mlp_match_jax():
    rng = np.random.default_rng(0)
    xj, xt = _both(rng, 3, 5, 64)
    sj, st = _both(rng, 64)
    np.testing.assert_allclose(_np(tl.rms_norm(xt, st, 1e-6)),
                               np.asarray(jl.rms_norm(xj, sj, 1e-6)), **TOL)
    # weights at the model's init scale, 1/sqrt(fan-in), so outputs are O(1)
    ws = [tuple(w / np.sqrt(shape[0]) for w in _both(rng, *shape))
          for shape in ((64, 128), (64, 128), (128, 64))]
    for act in ("silu", "gelu"):
        got = tl.gated_mlp(xt, *(w[1] for w in ws), act)
        ref = jl.gated_mlp(xj, *(w[0] for w in ws), act)
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("theta", [500_000.0, 10_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng, 2, 7, 4, 16)
    np.testing.assert_allclose(_np(tl.rope_frequencies(16, theta)),
                               np.asarray(jl.rope_frequencies(16, theta)), **TOL)
    pos = np.arange(7, dtype=np.int32)
    np.testing.assert_allclose(
        _np(tl.apply_rope(xt, torch.from_numpy(pos), theta)),
        np.asarray(jl.apply_rope(xj, jnp.asarray(pos), theta)), **TOL)
    per_row = np.stack([pos + 3, pos * 5]).astype(np.int32)  # (B, S) positions
    np.testing.assert_allclose(
        _np(tl.apply_rope(xt, torch.from_numpy(per_row), theta)),
        np.asarray(jl.apply_rope(xj, jnp.asarray(per_row), theta)), **TOL)


@pytest.mark.parametrize("window", [GLOBAL, 3, 1])
def test_causal_window_bias_matches_jax(window):
    qp, kp = np.arange(4, 10), np.arange(10)
    got = tl.causal_window_bias(torch.from_numpy(qp), torch.from_numpy(kp), window)
    ref = jl.causal_window_bias(jnp.asarray(qp), jnp.asarray(kp), window)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


@pytest.mark.parametrize("window,bidirectional,hkv", [
    (GLOBAL, False, 2), (3, False, 2), (GLOBAL, True, 2), (GLOBAL, False, 4),
    (GLOBAL, False, 1)])
def test_attention_xla_matches_jax(window, bidirectional, hkv):
    rng = np.random.default_rng(2)
    qj, qt = _both(rng, 2, 6, 4, 16)
    kj, kt = _both(rng, 2, 6, hkv, 16)
    vj, vt = _both(rng, 2, 6, hkv, 16)
    pos = np.arange(6)
    got = tl.attention_xla(qt, kt, vt, torch.from_numpy(pos), torch.from_numpy(pos),
                           window, bidirectional=bidirectional)
    ref = jl.attention_xla(qj, kj, vj, jnp.asarray(pos), jnp.asarray(pos), window,
                           bidirectional=bidirectional)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("window", [GLOBAL, 4])
def test_attention_decode_matches_jax(window):
    rng = np.random.default_rng(3)
    qj, qt = _both(rng, 3, 1, 4, 16)
    kj, kt = _both(rng, 3, 10, 2, 16)
    vj, vt = _both(rng, 3, 10, 2, 16)
    qpos = np.array([2, 9, 0], np.int32)
    got = tl.attention_decode(qt, kt, vt, torch.from_numpy(qpos), window)
    ref = jl.attention_decode(qj, kj, vj, jnp.asarray(qpos), window)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


def test_select_attention_routes_and_refuses_the_unported_path():
    rng = np.random.default_rng(4)
    _, q = _both(rng, 1, 8, 4, 16)
    _, k = _both(rng, 1, 8, 2, 16)
    pos = torch.arange(8)
    xla = tl.select_attention("xla", q, k, k, pos, pos, GLOBAL)
    np.testing.assert_allclose(_np(tl.select_attention("auto", q, k, k, pos, pos, GLOBAL)),
                               _np(xla), **TOL)
    np.testing.assert_allclose(_np(tl.select_attention("flash", q, k, k, pos, pos, GLOBAL)),
                               _np(xla), **TOL)
    # the chunked path, once refused, now routes (held against JAX in
    # tests/test_torch_chunked_attention.py)
    np.testing.assert_allclose(_np(tl.select_attention("xla_chunked", q, k, k, pos, pos,
                                                       GLOBAL, chunk_q=3, chunk_kv=5)),
                               _np(xla), **TOL)
    with pytest.raises(ValueError):
        tl.select_attention("nope", q, k, k, pos, pos, GLOBAL)


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
def test_config_params_and_flops_match_jax():
    from repro.configs import get_config as jax_config

    tc, jc = get_config("llama3.2-1b"), jax_config("llama3.2-1b")
    for f in dataclasses.fields(jc):
        tv, jv = getattr(tc, f.name), getattr(jc, f.name)
        assert (tv.value, tv.name) == (jv.value, jv.name) if f.name == "family" else tv == jv, f.name
    assert tc.padded_vocab == jc.padded_vocab and tc.layer_windows() == jc.layer_windows()
    jcfg, jm, jp, tcfg, tm, tp = _models()
    assert tm.param_count() == jm.param_count()
    assert tm.flops_per_token(train=False) == jm.flops_per_token(train=False)
    full_j, full_t = jax_build(jax_config("llama3.2-1b")), build_model(get_config("llama3.2-1b"))
    assert full_t.param_count() == full_j.param_count() == 1_235_814_400
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_prefill_and_decode_match_jax(attn_impl):
    """Prefill of a 7-token prompt into a 12-long cache, then three decode
    steps, logits and caches compared at each."""
    jcfg, jm, jp, tcfg, tm, tp = _models(attn_impl=attn_impl, scan_layers=False)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 256, (2, 7)).astype(np.int32)
    jl_, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, cache_len=12)
    with torch.no_grad():
        tl_, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)}, cache_len=12)
    np.testing.assert_allclose(_np(tl_), np.asarray(jl_), **MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]), **MODEL_TOL)
    assert tc["pos"] == int(jc["pos"]) == 7
    tok = np.argmax(np.asarray(jl_)[:, -1], axis=-1).astype(np.int32)[:, None]
    for _ in range(3):
        jl_, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        with torch.no_grad():
            tl_, tc = tm.decode_step(tp, tc, torch.from_numpy(tok).long())
        np.testing.assert_allclose(_np(tl_), np.asarray(jl_), **MODEL_TOL)
        np.testing.assert_allclose(_np(tc["k"]), np.asarray(jc["k"]), **MODEL_TOL)
        tok = np.argmax(np.asarray(jl_)[:, -1], axis=-1).astype(np.int32)[:, None]
    assert tc["pos"] == int(jc["pos"]) == 10


def test_forward_hidden_matches_jax_with_a_sliding_window():
    """A window pattern (local, global) exercises the per-layer window and
    the local RoPE theta; bidirectional-free causal prefill only."""
    jcfg, jm, jp, tcfg, tm, tp = _models(window_pattern=(4, GLOBAL), scan_layers=False)
    tokens = np.random.default_rng(6).integers(0, 256, (1, 9)).astype(np.int32)
    ref = jtf.forward_hidden(jp, jcfg, tokens=jnp.asarray(tokens))
    with torch.no_grad():
        got = ttf.forward_hidden(tp, tcfg, tokens=torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got), np.asarray(ref), **MODEL_TOL)


def test_unported_families_and_bad_trees_raise():
    """Every family of the JAX roster builds now (seamless-m4t-medium,
    the last to raise here, included); an unknown arch and a tree that
    does not fit its declarations still raise."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models import Family

    seamless = get_config("seamless-m4t-medium")
    assert seamless.family is Family.ENCDEC and seamless.num_encoder_layers == 12
    assert build_model(seamless).cfg is seamless
    assert len(ARCH_IDS) == 10 and all(get_config(a).name == a for a in ARCH_IDS)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    cfg = get_reduced("llama3.2-1b", **F32)
    good = jax.tree.map(np.asarray, jax_build(jax_reduced("llama3.2-1b", **F32)).init(
        jax.random.PRNGKey(1)))
    bad = dict(good, final_norm=np.zeros((63,), np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        convert.model_params_from_jax(cfg, bad, device="cpu")
    # hymba's float32 SSM leaves in a bf16 tree: a missing one, or one in
    # bf16, is refused
    hcfg = get_reduced("hymba-1.5b")
    hgood = jax.tree.map(np.asarray, jax_build(jax_reduced("hymba-1.5b")).init(
        jax.random.PRNGKey(1)))
    assert convert.model_params_from_jax(hcfg, hgood, device="cpu")["layers"][
        "ssm_a_log"].dtype == torch.float32
    layers = dict(hgood["layers"])
    layers.pop("ssm_dt_bias")
    with pytest.raises(ValueError, match="keys"):
        convert.model_params_from_jax(hcfg, dict(hgood, layers=layers), device="cpu")
    layers = dict(hgood["layers"], ssm_d=hgood["layers"]["ssm_d"].astype(
        hgood["layers"]["wq"].dtype))
    with pytest.raises(ValueError, match="ssm_d: dtype"):
        convert.model_params_from_jax(hcfg, dict(hgood, layers=layers), device="cpu")


def test_init_is_seeded_and_in_the_config_dtype():
    cfg = get_reduced("llama3.2-1b")
    model = build_model(cfg)
    draws = []
    for _ in range(2):
        g = torch.Generator()
        g.manual_seed(3)
        draws.append(model.init(g))
    assert draws[0]["layers"]["wq"].dtype == torch.bfloat16
    assert torch.equal(draws[0]["layers"]["wq"], draws[1]["layers"]["wq"])
    assert float(draws[0]["final_norm"].abs().sum()) == 0.0  # "zeros" init
    std = float(draws[0]["layers"]["w_up"].float().std())
    assert abs(std - 64 ** -0.5) < 0.01  # normal, 1/sqrt(fan-in)
