"""The tensor-parallel DENSE layer on 4 CPU ranks (gloo) against the JAX
package's functions: layer 0's attention block (``_attn_block``), the
gated MLP (``layers.gated_mlp``) and the whole training loss
(``Model.loss``: the vocabulary-parallel embedding and cross-entropy).

Each rank holds its blocks of the JAX initial parameters
(``convert.shard_params``) under a ``MeshPlan`` with a model split
(client × tp × sp = 4; the client groups compute the same) and
computes the layer through ``dist.tensor_parallel``'s copy, reduce,
gather and vocabulary-parallel cross-entropy. Held to ``MODEL_TOL``
(float32; the row-parallel partial sums add in another order): the
output, the input's gradient of Σ output·cot and every parameter's
gradient, gathered whole; and one rank's blocks and the blocks of its
model group reassembled (``convert.whole_params``) against the JAX
parameters, exactly. The cases cover attention with the kv heads split
(tp 2) and replicated (tp 4 over the reduced configs' 2 kv heads),
RoPE and ``qk_norm`` over a ``head_dim`` split over sp, the qkv bias,
the MLP over tp × sp, and the loss with a padded vocabulary and a
logit softcap, tied (gemma3) and untied (qwen2.5) heads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_parity import MODEL_TOL, one_thread  # noqa: F401 (autouse)
from _tp_cases import rank_layer, torch_cfg

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models import layers as jl
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.dist.meshes import Mesh, MeshPlan
from repro_torch.dist.sharding import ShardingRules, spec_slices
from repro_torch.dist.world import World
from repro_torch.models.api import decls

B, S = 2, 16
SOFTCAP = dict(vocab_size=250, logit_softcap=30.0)  # padded to 256 rows


@pytest.fixture(scope="module")
def world():
    with World(4, backend="gloo", device="cpu", timeout=300.0) as w:
        yield w


def jax_setup(arch, over):
    cfg = dataclasses.replace(
        jax_reduced(arch, param_dtype="float32", compute_dtype="float32"), **over)
    model = jax_build(cfg)
    params = model.init(jax.random.PRNGKey(1))
    return cfg, model, params


def split_of(tp, sp):
    return (4 // (tp * sp), 1, tp, sp)


def run(world, arch, over, split, layer, **inputs):
    cfg, model, params = jax_setup(arch, over)
    spec = dict(arch=arch, over=over, split=split, layer=layer,
                params=jax.tree.map(np.asarray, params), **inputs)
    return cfg, model, params, world.run(rank_layer, spec)


def vjp_of(f):
    """(output, parameter gradient, input gradient) of Σ f(lp, x)·cot."""

    def run(lp, x, cot):
        out, vjp = jax.vjp(f, lp, x)
        return (out, *vjp(cot))

    return run


def hold_grads(jgrads, got):
    assert len(jax.tree.leaves(jgrads)) == len(got)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0], got):
        np.testing.assert_allclose(b, np.asarray(a), err_msg=jax.tree_util.keystr(path),
                                   **MODEL_TOL)


def hold_blocks(arch, over, split, ranks, params):
    """Rank 0's blocks are its slices of the JAX parameters, and its model
    group's blocks reassemble the whole tree exactly."""
    cfg = torch_cfg(arch, over)
    client, zero, t, s = split
    plan = MeshPlan(1, client, zero, ("tp", "sp"), (t, s))
    mesh = Mesh(plan.axis_names, plan.axis_sizes, 0, None, "gloo")
    rules = ShardingRules(cfg=cfg, plan=plan, mesh=mesh)
    d = decls(cfg)
    whole = jax.tree.leaves(jax.tree.map(np.asarray, params))
    for x, blk, spec, dl in zip(whole, ranks[0]["blocks"], rules.tensor_specs(d),
                                jax.tree.leaves(d, is_leaf=lambda n: hasattr(n, "axes"))):
        np.testing.assert_array_equal(blk, x[spec_slices(spec, dl.shape, mesh.shape,
                                                          mesh.coords)])
    group = ranks[:t * s]  # rank 0's model group, member order
    blocks = [jax.tree.unflatten(jax.tree.structure(params),
                                 [torch.from_numpy(b) for b in r["blocks"]]) for r in group]
    back = convert.whole_params(cfg, blocks, rules)
    for a, b in zip(whole, jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("arch,over,tp,sp", [
    ("llama3.2-1b", {}, 2, 1),  # kv heads split over tp
    ("llama3.2-1b", {}, 4, 1),  # 2 kv heads replicated over tp 4
    ("gemma3-12b", {}, 1, 2),  # qk_norm + RoPE over a split head_dim, window
    ("gemma3-12b", {}, 2, 2),
    ("qwen2.5-14b", {}, 2, 2),  # qkv bias
], ids=["llama-tp2", "llama-tp4-kv-replicated", "gemma3-sp2", "gemma3-tp2-sp2",
        "qwen-tp2-sp2"])
def test_attention_block_matches_jax(world, arch, over, tp, sp):
    rng = np.random.default_rng(3)
    cfg0 = torch_cfg(arch, over)
    x = rng.standard_normal((B, S, cfg0.d_model)).astype(np.float32)
    cot = rng.standard_normal((B, S, cfg0.d_model)).astype(np.float32)
    cfg, _, params, ranks = run(world, arch, over, split_of(tp, sp), "attn", x=x, cot=cot)
    lp0 = jax.tree.map(lambda v: v[0], params["layers"])
    w, theta = jtf.static_layer_meta(cfg, 0)

    def f(lp, xx):
        return jtf._attn_block(lp, cfg, xx, jnp.arange(S), w, theta)[0]

    out, g_lp, g_x = jax.jit(vjp_of(f))(lp0, jnp.asarray(x), jnp.asarray(cot))
    g_params = jax.tree.map(jnp.zeros_like, params)
    g_params["layers"] = jax.tree.map(lambda z, g: z.at[0].set(g), g_params["layers"],
                                      {k: g_lp[k] for k in g_params["layers"]})
    for r in ranks:
        np.testing.assert_allclose(r["out"], np.asarray(out), **MODEL_TOL)
        np.testing.assert_allclose(r["grad_x"], np.asarray(g_x), **MODEL_TOL)
        hold_grads(g_params, r["grads"])
    hold_blocks(arch, over, split_of(tp, sp), ranks, params)
    # each rank holds only its block of what the rule table splits
    hq, hd = cfg.num_heads // tp, cfg.head_dim // sp
    hkv = cfg.num_kv_heads // tp if cfg.num_kv_heads % tp == 0 else cfg.num_kv_heads
    shapes = ranks[0]["local_shapes"]
    assert shapes["layers/wq"] == (cfg.num_layers, cfg.d_model, hq, hd)
    assert shapes["layers/wk"] == (cfg.num_layers, cfg.d_model, hkv, hd)
    assert shapes["layers/wo"] == (cfg.num_layers, hq, hd, cfg.d_model)


@pytest.mark.parametrize("tp,sp", [(2, 2), (4, 1)], ids=["tp2-sp2", "tp4"])
def test_mlp_matches_jax(world, tp, sp):
    rng = np.random.default_rng(4)
    cfg0 = torch_cfg("llama3.2-1b")
    x = rng.standard_normal((B, S, cfg0.d_model)).astype(np.float32)
    cot = rng.standard_normal((B, S, cfg0.d_model)).astype(np.float32)
    cfg, _, params, ranks = run(world, "llama3.2-1b", {}, split_of(tp, sp), "mlp", x=x, cot=cot)
    lp0 = {k: params["layers"][k][0] for k in ("w_gate", "w_up", "w_down")}

    def f(lp, xx):
        return jl.gated_mlp(xx, lp["w_gate"], lp["w_up"], lp["w_down"], cfg.act)

    out, g_lp, g_x = jax.jit(vjp_of(f))(lp0, jnp.asarray(x), jnp.asarray(cot))
    g_params = jax.tree.map(jnp.zeros_like, params)
    for k in lp0:
        g_params["layers"][k] = g_params["layers"][k].at[0].set(g_lp[k])
    for r in ranks:
        np.testing.assert_allclose(r["out"], np.asarray(out), **MODEL_TOL)
        np.testing.assert_allclose(r["grad_x"], np.asarray(g_x), **MODEL_TOL)
        hold_grads(g_params, r["grads"])
    assert ranks[0]["local_shapes"]["layers/w_gate"] == (cfg.num_layers, cfg.d_model,
                                                         cfg.d_ff // (tp * sp))


@pytest.mark.parametrize("arch,over,tp,sp", [
    ("llama3.2-1b", SOFTCAP, 2, 2),  # padded rows, softcap, tied
    ("gemma3-12b", {}, 4, 1),  # tied, scaled embeddings, qk_norm
    ("qwen2.5-14b", {}, 1, 2),  # untied head, bias
], ids=["llama-padded-softcap-tp2-sp2", "gemma3-tp4", "qwen-sp2"])
def test_loss_matches_jax(world, arch, over, tp, sp):
    rng = np.random.default_rng(5)
    cfg0 = torch_cfg(arch, over)
    toks = rng.integers(0, cfg0.vocab_size, (B, S + 1)).astype(np.int64)
    cfg, model, params, ranks = run(world, arch, over, split_of(tp, sp), "loss", tokens=toks)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, {"tokens": jnp.asarray(toks)})))(params)
    for r in ranks:
        np.testing.assert_allclose(r["out"], np.asarray(loss), **MODEL_TOL)
        hold_grads(g, r["grads"])
    hold_blocks(arch, over, split_of(tp, sp), ranks, params)
    assert ranks[0]["local_shapes"]["embed"] == (cfg.padded_vocab // (tp * sp), cfg.d_model)
