"""The port's rwkv6 model (``repro_torch.models.rwkv6``, the SSM family)
against the JAX package's, on the reduced rwkv6-1.6b with d_model 128 (two
wkv heads of 64), two layers, d_ff 128, vocab 256, in float32, with the
JAX parameters carried across by ``convert.model_params_from_jax``. The
leaves the JAX init sets to zero (norm scales, token-shift vectors, the
decay base, the bonus u) get numpy-seeded values first, so every term of
the model is exercised. Inputs come from a numpy seed.

Tolerances: 1e-4 relative + 2e-5 absolute for hidden states, logits and
the recurrent state (float32; XLA and ATen order their sums and compute
exp / tanh differently, a few ulps apart, carried through two layers and
the LM head). On the CPU the prefill's recurrence runs K6's plain
version; the decode step's is the plain one-token recurrence.
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
from repro.models import rwkv6 as jrwkv
from repro_torch import convert
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.models import Family, build_model, rwkv6, ssm

F32 = dict(param_dtype="float32", compute_dtype="float32")
SMALL = dict(d_model=128, **F32)
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)
# leaves the JAX init leaves at zero, and the scale of the values they get
ZERO_LEAVES = {"ln_tm": 0.1, "ln_cm": 0.1, "maa_x": 0.3, "maa_wkvrg": 0.3, "decay": 0.5,
               "u": 0.3, "ln_x": 0.1, "cm_maa_k": 0.3, "cm_maa_r": 0.3}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def jax_params(jm, seed=0):
    """The JAX init with its zero leaves given numpy-seeded values."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    for name, scale in ZERO_LEAVES.items():
        leaf = p["layers"][name]
        p["layers"][name] = (scale * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    p["final_norm"] = (0.1 * rng.standard_normal(p["final_norm"].shape)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced("rwkv6-1.6b", loss_chunk=0, **SMALL)
    tcfg = get_reduced("rwkv6-1.6b", **SMALL)
    jm = jax_build(jcfg)
    p = jax_params(jm)
    jp = jax.tree.map(jnp.asarray, p)
    tp = convert.model_params_from_jax(tcfg, p, device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


def test_config_and_parameter_counts_match_jax():
    tc, jc = get_config("rwkv6-1.6b"), jax_config("rwkv6-1.6b")
    for f in dataclasses.fields(jc):
        tv, jv = getattr(tc, f.name), getattr(jc, f.name)
        assert (tv.value, tv.name) == (jv.value, jv.name) if f.name == "family" else tv == jv, f.name
    assert tc.family is Family.SSM and rwkv6.num_heads(tc) == 32
    full_t, full_j = build_model(tc), jax_build(jc)
    assert full_t.param_count() == full_j.param_count() == 1_599_719_424
    assert full_t.flops_per_token(train=False) == full_j.flops_per_token(train=False)
    small_t = build_model(get_reduced("rwkv6-1.6b", **SMALL))
    small_j = jax_build(jax_reduced("rwkv6-1.6b", **SMALL))
    assert small_t.param_count() == small_j.param_count()
    # reduced() at its default width gives one head; the tests take d 128
    assert rwkv6.num_heads(get_reduced("rwkv6-1.6b")) == 1
    assert rwkv6.num_heads(get_reduced("rwkv6-1.6b", **SMALL)) == 2


def test_params_carry_across_with_their_dtypes():
    """A bf16 JAX tree keeps ``decay`` and ``u`` in float32; the port's
    tree matches the declarations in keys, shapes and dtypes, and a tree
    that does not raises."""
    jcfg = jax_reduced("rwkv6-1.6b", d_model=128)
    tcfg = get_reduced("rwkv6-1.6b", d_model=128)
    p = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(1)))
    tp = convert.model_params_from_jax(tcfg, p, device="cpu")
    assert tp["layers"]["decay"].dtype == tp["layers"]["u"].dtype == torch.float32
    assert tp["layers"]["wr"].dtype == tp["embed"].dtype == torch.bfloat16
    init = build_model(tcfg).init(torch.Generator().manual_seed(0))
    for k, v in init["layers"].items():
        assert v.dtype == tp["layers"][k].dtype and v.shape == tp["layers"][k].shape, k
    bad = dict(p, layers=dict(p["layers"], u=p["layers"]["u"].astype(np.float16)))
    with pytest.raises(ValueError, match="u: dtype"):
        convert.model_params_from_jax(tcfg, bad, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        renamed = {("extra" if k == "lm_head" else k): v for k, v in p.items()}
        convert.model_params_from_jax(tcfg, renamed, device="cpu")


def test_forward_hidden_matches_jax(models):
    jcfg, jm, jp, tcfg, tm, tp = models
    tokens = np.random.default_rng(1).integers(0, 256, (2, 11)).astype(np.int32)
    ref = jrwkv.forward_hidden(jp, jcfg, tokens=jnp.asarray(tokens))
    with torch.no_grad():
        got = rwkv6.forward_hidden(tp, tcfg, tokens=torch.from_numpy(tokens).long())
    np.testing.assert_allclose(_np(got), _np(ref), **MODEL_TOL)


def test_layers_match_jax_with_and_without_a_state(models):
    """One layer's time-mix and channel-mix, from zero (the prefill's
    route) and from a carried state (the decode step's)."""
    jcfg, jm, jp, tcfg, tm, tp = models
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    st = {"wkv": rng.standard_normal((2, 2, 64, 64)).astype(np.float32),
          "tm_x": rng.standard_normal((2, 128)).astype(np.float32),
          "cm_x": rng.standard_normal((2, 128)).astype(np.float32)}
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    tlp = rwkv6.layer_params(tp, 1)
    for state in (None, st):
        jout, jst = jrwkv._layer(jlp, jnp.asarray(x), jcfg,
                                 None if state is None else jax.tree.map(jnp.asarray, state),
                                 chunk=5)
        with torch.no_grad():
            tout, tst = rwkv6._layer(tlp, torch.from_numpy(x), tcfg,
                                     None if state is None else
                                     {k: torch.from_numpy(v) for k, v in state.items()})
        np.testing.assert_allclose(_np(tout), _np(jout), **MODEL_TOL)
        for key in ("wkv", "tm_x", "cm_x"):
            np.testing.assert_allclose(_np(tst[key]), _np(jst[key]), **MODEL_TOL)


def test_prefill_and_three_decode_steps_match_jax(models):
    """Prefill of a 9-token prompt: logits and the wkv / tm_x / cm_x
    state; then three decode steps, logits and state at each."""
    jcfg, jm, jp, tcfg, tm, tp = models
    prompt = np.random.default_rng(3).integers(0, 256, (2, 9)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, cache_len=16)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()}, cache_len=16)
    np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
    for key in ("wkv", "tm_x", "cm_x"):
        np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **MODEL_TOL)
    assert tc["pos"] == int(jc["pos"]) == 9
    tok = np.argmax(_np(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok).long())
        np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
        for key in ("wkv", "tm_x", "cm_x"):
            np.testing.assert_allclose(_np(tc[key]), _np(jc[key]), **MODEL_TOL)
        tok = np.argmax(_np(jl)[:, -1], axis=-1).astype(np.int32)[:, None]
    assert tc["pos"] == int(jc["pos"]) == 12


def test_time_mix_routes_the_recurrence_by_its_arguments(models, monkeypatch):
    """No state: K6's entry point (its plain version here, on the CPU); a
    state: the plain recurrence of models.ssm. Decided by the arguments."""
    *_, tcfg, tm, tp = models
    calls = {"kernel": 0, "plain": 0}
    kernel, plain = wkv6_ops.wkv6, ssm.wkv6

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(wkv6_ops, "wkv6", count("kernel", kernel))
    monkeypatch.setattr(ssm, "wkv6", count("plain", plain))
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (1, 6)))
    with torch.no_grad():
        logits, cache = tm.prefill(tp, {"tokens": prompt}, cache_len=0)
        assert calls == {"kernel": tcfg.num_layers, "plain": 0}
        tm.decode_step(tp, cache, torch.argmax(logits[:, -1], -1)[:, None])
    assert calls == {"kernel": tcfg.num_layers, "plain": tcfg.num_layers}


def test_build_model_serves_rwkv6_and_the_rest_still_raise():
    """rwkv6 builds as the SSM family, and the families that raised here
    before (HYBRID, ENCDEC) build as theirs now; the SSM family's cache."""
    model = build_model(get_config("rwkv6-1.6b"))
    assert model.cfg.family is Family.SSM
    for arch, family in (("hymba-1.5b", Family.HYBRID),
                         ("seamless-m4t-medium", Family.ENCDEC)):
        assert build_model(get_config(arch)).cfg.family is family
    cache = build_model(get_reduced("rwkv6-1.6b", **SMALL)).init_cache(3, 99, device="cpu")
    assert tuple(cache["wkv"].shape) == (2, 3, 2, 64, 64) and cache["pos"] == 0
    assert cache["wkv"].dtype == torch.float32 and tuple(cache["tm_x"].shape) == (2, 3, 128)


def test_prefill_past_the_jax_scan_chunk_keeps_the_state(models):
    """A 130-token prompt: the JAX prefill's logits are right but its
    ``wkv`` state comes back zero (its scan pads T to the 128-step chunk
    with w = 0; ROADMAP.md R6). The port's logits equal the JAX ones, and
    its state equals a 128-token prefill followed by two decode steps."""
    jcfg, jm, jp, tcfg, tm, tp = models
    prompt = np.random.default_rng(5).integers(0, 256, (1, 130)).astype(np.int32)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, cache_len=130)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(prompt).long()}, cache_len=130)
        _, step = tm.prefill(tp, {"tokens": torch.from_numpy(prompt[:, :128]).long()},
                             cache_len=130)
        for i in (128, 129):
            _, step = tm.decode_step(tp, step, torch.from_numpy(prompt[:, i:i + 1]).long())
    np.testing.assert_allclose(_np(tl), _np(jl), **MODEL_TOL)
    assert float(tc["wkv"].abs().max()) > 0
    for key in ("wkv", "tm_x", "cm_x"):
        np.testing.assert_allclose(_np(tc[key]), _np(step[key]), **MODEL_TOL)
