"""The port's training loss (``transformer.lm_loss`` / ``_chunked_ce``,
``rwkv6.lm_loss``, ``Model.loss``) against the JAX package's, on the
reduced llama3.2-1b (2 layers, d 64) and rwkv6-1.6b (2 layers, d 128, two
heads) with the JAX parameters carried across, tokens from a numpy seed.

float32: the loss and every gradient (``torch.autograd`` against
``jax.value_and_grad``) to ``rtol=1e-4, atol=2e-5`` (MODEL_TOL of
``test_torch_models.py``; the backward doubles the forward's reordered
sums). bf16: the loss only, to ``rtol=2e-2`` (bf16 activations, ~3
significant digits, through two layers and the tied head).
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
from repro.models import rwkv6 as jrwkv6
from repro.models import transformer as jtf
from repro_torch import convert, tree
from repro_torch.configs import get_reduced
from repro_torch.models import build_model, rwkv6, transformer

F32 = dict(param_dtype="float32", compute_dtype="float32")
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)
BF16_LOSS_RTOL = 2e-2


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)


def _params(arch, **over):
    jcfg, tcfg = jax_reduced(arch, **over), get_reduced(arch, **over)
    p = jax.tree.map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0)))
    if arch == "rwkv6-1.6b":  # the JAX init leaves these at zero
        rng = np.random.default_rng(1)
        for name in ("decay", "u", "maa_x", "maa_wkvrg", "ln_x"):
            leaf = p["layers"][name]
            p["layers"][name] = (0.3 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
    return jcfg, tcfg, p


def _grads(jmod, tmod, jcfg, tcfg, p, toks, mask=None):
    """(JAX (loss, grads), port (loss, grads)) of ``lm_loss``."""
    def jloss(params):
        return jmod.lm_loss(params, jcfg, tokens=jnp.asarray(toks[:, :-1]),
                            targets=jnp.asarray(toks[:, 1:]),
                            loss_mask=None if mask is None else jnp.asarray(mask))

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, p))
    tp = convert.model_params_from_jax(tcfg, p, device="cpu")
    leaves = [x.requires_grad_(True) for x in tree.leaves(tp)]
    tl = tmod.lm_loss(tree.unflatten(tp, leaves), tcfg,
                      tokens=torch.from_numpy(toks[:, :-1]),
                      targets=torch.from_numpy(toks[:, 1:]),
                      loss_mask=None if mask is None else torch.from_numpy(mask))
    tg = torch.autograd.grad(tl, leaves)
    return (jl, jg), (tl, tree.unflatten(tp, list(tg)))


def _hold(j, t):
    (jl, jg), (tl, tg) = j, t
    np.testing.assert_allclose(float(tl.detach()), float(jl), **MODEL_TOL)
    paths = jax.tree_util.tree_flatten_with_path(jg)[0]
    for (path, a), b in zip(paths, tree.leaves(tg)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   err_msg=jax.tree_util.keystr(path), **MODEL_TOL)


@pytest.mark.parametrize("chunk,seq,masked", [(0, 16, False), (5, 13, False),
                                              (5, 13, True)],
                         ids=["whole", "padded-chunks", "padded-chunks-masked"])
def test_llama_loss_and_grads_match_jax(chunk, seq, masked):
    """``loss_chunk`` 0 (one chunk) and a chunk of 5 over 13 targets (the
    last chunk padded by 2 masked positions), with a caller's mask too."""
    jcfg, tcfg, p = _params("llama3.2-1b", loss_chunk=chunk, **F32)
    toks = _tokens(0, 3, seq)
    mask = ((np.random.default_rng(1).random((3, seq)) < 0.7).astype(np.float32)
            if masked else None)
    _hold(*_grads(jtf, transformer, jcfg, tcfg, p, toks, mask))


def test_rwkv6_loss_and_grads_match_jax():
    """rwkv6's loss runs the plain recurrence (K6 is forward-only)."""
    jcfg, tcfg, p = _params("rwkv6-1.6b", d_model=128, **F32)
    _hold(*_grads(jrwkv6, rwkv6, jcfg, tcfg, p, _tokens(2, 2, 12)))


@pytest.mark.parametrize("arch,over", [("llama3.2-1b", {}), ("llama3.2-1b", dict(loss_chunk=4)),
                                       ("rwkv6-1.6b", dict(d_model=128))],
                         ids=["llama", "llama-chunked", "rwkv6"])
def test_bf16_loss_matches_jax(arch, over):
    jcfg, tcfg, p = _params(arch, **over)
    toks = _tokens(3, 2, 10)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jl = jm.loss(jax.tree.map(jnp.asarray, p), {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl = tm.loss(convert.model_params_from_jax(tcfg, p, device="cpu"),
                     {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_LOSS_RTOL)


def test_model_loss_splits_the_batch():
    """``Model.loss`` takes (B, S+1) tokens: inputs [:-1], targets [1:]."""
    jcfg, tcfg, p = _params("llama3.2-1b", **F32)
    toks = _tokens(4, 2, 9)
    tp = convert.model_params_from_jax(tcfg, p, device="cpu")
    with torch.no_grad():
        a = build_model(tcfg).loss(tp, {"tokens": torch.from_numpy(toks)})
        b = transformer.lm_loss(tp, tcfg, tokens=torch.from_numpy(toks[:, :-1]),
                                targets=torch.from_numpy(toks[:, 1:]))
    assert torch.equal(a, b)


def test_flash_loss_raises():
    """K5 has no backward: a loss through attn_impl='flash' raises."""
    tcfg = dataclasses.replace(get_reduced("llama3.2-1b", **F32), attn_impl="flash")
    with pytest.raises(NotImplementedError, match="backward"):
        build_model(tcfg).loss(None, {"tokens": torch.zeros((1, 5), dtype=torch.int64)})
