"""The tensor axes as arithmetic, without a world: the launcher's plan at
256 / 512 devices against the JAX package's (F3), each rank's blocks
(``ShardingRules.tensor_specs``, ``block_slices``, ``shard_tree`` and its
inverse ``assemble``), ``TensorParallel``'s view of the production plans
and what it refuses, the model axes' process groups, the tensor-axis
contract and readers on synthetic ledgers, and the selftest's plan and
bf16 bounds under a model split."""
import types

import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.dist import plan_for as jax_plan_for
from repro_torch import tree
from repro_torch.configs import get_config, get_reduced
from repro_torch.dist import selftest as st
from repro_torch.dist.collectives import (
    CollectiveOp,
    CollectiveStats,
    assert_inter_client_contract,
    tensor_axis_ops,
    tensor_axis_summary,
)
from repro_torch.dist.meshes import Mesh, MeshPlan, axis_groups
from repro_torch.dist.sharding import ShardingRules, local_shape
from repro_torch.dist.tensor_parallel import TensorParallel, _paths
from repro_torch.launch.train import mesh_plan
from repro_torch.models.api import decls

DENSE = ("llama3.2-1b", "qwen2.5-14b", "yi-9b", "gemma3-12b")
FIELDS = ("num_pods", "num_clients", "zero", "model_axes", "model_split", "fsdp_params")


def rules_at(cfg, plan: MeshPlan, rank: int = 0) -> ShardingRules:
    return ShardingRules(cfg, plan, Mesh(plan.axis_names, plan.axis_sizes, rank,
                                         torch.device("cpu"), "gloo"))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["256", "512-multi-pod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_f3_launcher_plan_is_the_production_plan(arch, multi_pod):
    """``launch/train.py --devices 256`` (512 with ``--multi-pod``) builds
    the JAX launcher's production plan, tensor axes included; any other
    count the scaled host plan."""
    pods = 2 if multi_pod else 1
    plan = mesh_plan(get_config(arch), 256 * pods, multi_pod)
    jplan = jax_plan_for(jax_config(arch), multi_pod=multi_pod)
    assert {f: getattr(plan, f) for f in FIELDS} == {f: getattr(jplan, f) for f in FIELDS}
    assert plan.shape == dict(jplan.shape) and plan.device_count == 256 * pods
    scaled = mesh_plan(get_config(arch), 8, multi_pod)
    jscaled = jax_plan_for(jax_config(arch), multi_pod=multi_pod, device_count=8)
    assert {f: getattr(scaled, f) for f in FIELDS} == {f: getattr(jscaled, f) for f in FIELDS}
    assert scaled.model_ways == 1


def test_f3_llama_production_plan():
    assert mesh_plan(get_config("llama3.2-1b"), 256).shape == {
        "client": 8, "zero": 2, "tp": 16, "sp": 1}


@pytest.mark.parametrize("arch", DENSE)
def test_production_blocks_of_the_dense_configs(arch):
    """Rank 0 of each production plan: the query heads over tp, the kv
    heads split where they divide and else every rank's whole block,
    head_dim over sp, mlp and vocab over tp × sp; blocks tile each leaf."""
    cfg = get_config(arch)
    plan = mesh_plan(cfg, 256)
    t, s = plan.model_split
    tp = TensorParallel.from_rules(rules_at(cfg, plan))
    local = {"/".join(p): d.shape
             for p, d in zip(_paths(tp.local_decls), tree.leaves(tp.local_decls))}
    hkv = cfg.num_kv_heads // t if cfg.num_kv_heads % t == 0 else cfg.num_kv_heads
    L, d = cfg.num_layers, cfg.d_model
    assert local["layers/wq"] == (L, d, cfg.num_heads // t, cfg.head_dim // s)
    assert local["layers/wk"] == (L, d, hkv, cfg.head_dim // s)
    assert local["layers/w_gate"] == (L, d, cfg.d_ff // (t * s))
    assert local["embed"] == (cfg.padded_vocab // (t * s), d)
    assert tp.q_heads == (0, cfg.num_heads // t)
    g = cfg.num_heads // cfg.num_kv_heads
    assert tp.kv_used[1] - tp.kv_used[0] == max(1, (cfg.num_heads // t) // g)
    copies = tp.leaf_copies
    assert copies["wq"] == () and copies["wo"] == ()
    assert copies["wk"] == (() if cfg.num_kv_heads % t == 0 else ("tp",))


@pytest.mark.parametrize("arch,match", [
    ("moonshot-v1-16b-a3b", "expert axis"), ("mixtral-8x7b", "expert axis"),
    ("hymba-1.5b", "hybrid"), ("internvl2-2b", "vlm"), ("seamless-m4t-medium", "encdec"),
    ("rwkv6-1.6b", "ssm"),
])
def test_tensor_axes_of_other_families_raise(arch, match):
    cfg = get_config(arch)
    with pytest.raises(NotImplementedError, match=f"(?i){match}.*item 11\\(b\\)"):
        TensorParallel.from_rules(rules_at(cfg, mesh_plan(cfg, 256)))


def test_heads_that_do_not_divide_tp_raise_and_scaled_plans_have_no_view():
    cfg = get_reduced("llama3.2-1b")  # 4 heads
    with pytest.raises(ValueError, match="heads do not divide"):
        TensorParallel.from_rules(rules_at(cfg, MeshPlan(1, 1, 1, ("tp", "sp"), (8, 1))))
    assert TensorParallel.from_rules(rules_at(cfg, mesh_plan(cfg, 8))) is None


@pytest.mark.parametrize("split", [(2, 1), (1, 2), (2, 2), (4, 1), (1, 4)])
def test_shard_and_assemble_are_inverse(split):
    cfg = get_reduced("gemma3-12b", param_dtype="float32")
    t, s = split
    plan = MeshPlan(1, 1, 1, ("tp", "sp"), (t, s))
    d = decls(cfg)
    gen = torch.Generator().manual_seed(0)
    whole = tree.map(lambda x: torch.randn(x.shape, generator=gen), d)
    r0 = rules_at(cfg, plan)
    blocks = [r0.shard_tree(whole, d, r0.member_coords(j)) for j in range(t * s)]
    back = r0.assemble(blocks, d)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(whole), tree.leaves(back)))
    for j, blk in enumerate(blocks):  # each member's blocks are its own rank's
        rj = rules_at(cfg, plan, rank=j)
        assert rj.member_coords(j) == rj.mesh.coords
        assert [tuple(x.shape) for x in tree.leaves(blk)] == [
            tuple(x.shape) for x in tree.leaves(rj.local_decls(d))]
        assert all(torch.equal(a, b) for a, b in zip(
            tree.leaves(blk), tree.leaves(rj.shard_tree(whole, d))))
    assert local_shape(("tp", None), (8, 3), {"tp": 4}) == (2, 3)


def test_model_axis_groups_and_member_order():
    plan = MeshPlan(1, 2, 1, ("tp", "sp"), (2, 2))
    sets = plan.axis_sets()
    assert sets[-4:] == [("tp",), ("sp",), ("tp", "sp"), ("client", "zero")]
    names, sizes = plan.axis_names, plan.axis_sizes
    assert axis_groups(names, sizes, ("tp", "sp")) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert axis_groups(names, sizes, ("tp",)) == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert axis_groups(names, sizes, ("client", "zero")) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    r = rules_at(get_reduced("llama3.2-1b"), plan, rank=5)
    assert [r.mesh.index(("tp", "sp"))] == [1]
    assert [sum(v * w for v, w in zip((c["client"], c["tp"], c["sp"]), (4, 2, 1)))
            for c in map(r.member_coords, range(4))] == [4, 5, 6, 7]
    assert MeshPlan(1, 8, 1, ("tp", "sp"), (1, 1)).axis_sets() == [("client",), ("zero",)]


def _rules(shape):
    mesh = types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))
    plan = types.SimpleNamespace(client_axes=("client",), model_axes=("tp", "sp"))
    return types.SimpleNamespace(mesh=mesh, plan=plan, client_ways=shape["client"])


def test_tensor_axis_contract_and_readers():
    """(client 2, zero 1, tp 2, sp 1): ranks 0-1 are client 0's model
    group. A collective over a model group passes; one whose group spans
    two client coordinates and the tensor axes fails; the readers take
    the ops confined to the model axes, by phase."""
    rules = _rules({"client": 2, "zero": 1, "tp": 2, "sp": 1})
    p = 100
    delta = CollectiveOp("all-reduce", 4.0 * (p + 2), [[0, 2]], 3.0, "server")
    ok = CollectiveStats((
        CollectiveOp("all-reduce", 64.0, [[0, 1]], 1.0, "local_training"),
        CollectiveOp("all-gather", 128.0, [[0, 1]], 2.0, "local_training"),
        CollectiveOp("all-gather", 400.0, [[0, 1]], 5.0, "gather"),
        delta,
        CollectiveOp("all-reduce", 8.0, [[0, 2]], 0.1, "local_training"),  # the loss
    ))
    assert assert_inter_client_contract(ok, rules, p) == (1, 4.0 * p)
    assert len(tensor_axis_ops(ok, rules)) == 3
    assert tensor_axis_summary(ok, rules, 2) == dict(
        count=1.0, bytes=96.0, ms=1.5, by_kind={"all-reduce": 0.5, "all-gather": 0.5})
    assert tensor_axis_summary(ok, rules, 1, phase="gather")["bytes"] == 400.0
    bad = CollectiveStats(ok.ops + (CollectiveOp("all-reduce", 64.0, [[0, 1, 2, 3]]),))
    with pytest.raises(AssertionError, match="span two client coordinates"):
        assert_inter_client_contract(bad, rules, p)


def test_selftest_plan_and_bf16_bounds():
    cut = st.model_config("qwen2.5-14b", "full", dtype="float32", layers=4)
    assert (cut.num_layers, cut.param_dtype, cut.compute_dtype, cut.d_model) == (
        4, "float32", "float32", get_config("qwen2.5-14b").d_model)
    cfg = get_reduced("llama3.2-1b")
    plan = st.selftest_plan(cfg, 8, zero=None, fog_nodes=1, model_split=(2, 2))
    assert plan.shape == {"client": 2, "zero": 1, "tp": 2, "sp": 2}
    assert st.selftest_plan(cfg, 8, zero=None, fog_nodes=2,
                            model_split=(2, 1)).shape == {"pod": 2, "client": 2, "zero": 1,
                                                          "tp": 2, "sp": 1}
    with pytest.raises(ValueError, match="do not divide"):
        st.selftest_plan(cfg, 6, zero=None, fog_nodes=1, model_split=(4, 1))
    mu = torch.tensor([1e-3, -4e-3, 2e-3])
    f = st.element_bound(mu, "params", tensor=True).numpy()
    np.testing.assert_allclose(f, st.F32_ATOL + st.F32_RTOL * np.abs(mu.numpy()))


def _fp(vals):
    return dict(vals=np.asarray(vals, dtype=np.float64))


@pytest.mark.parametrize("scale,ok", [(1.0, True), (st.BF16_TP_FACTOR, True),
                                      (2.5 * st.BF16_TP_FACTOR, False)])
def test_bf16_tensor_runs_are_held_against_float32(scale, ok):
    """Rank 0 may be ``BF16_TP_FACTOR`` times as far from the float32 round
    as the single-process bf16 round is (rms over a leaf's samples)."""
    truth = np.linspace(-1.0, 1.0, 64)
    noise = np.random.default_rng(0).standard_normal(64) * 1e-3
    ref = truth + noise
    mine = truth + scale * noise[::-1]
    res = st._hold_truth([_fp(mine)], [_fp(ref)], [_fp(truth)])
    assert res["ok"] is ok
    np.testing.assert_allclose(res["worst_rms_ratio"], scale, rtol=1e-9)
    exact = st._hold_truth([_fp(truth)], [_fp(truth)], [_fp(truth)])
    assert exact["ok"] and exact["worst_share_of_tol"] == 0.0

def test_forward_and_serving_on_blocks_raise():
    """DENSE serving on tensor-parallel blocks is built: a rank's cache and
    pool hold the kv heads its query heads read (its prefill and decode
    steps run in ``tests/test_torch_serve_dist*.py``); every other family
    on blocks or a sequence split, and the expert axis, still raise,
    naming item 11(b)."""
    from repro_torch.models import Runtime, build_model
    from repro_torch.models import transformer as tf

    cfg = get_reduced("llama3.2-1b")
    tp = TensorParallel.from_rules(rules_at(cfg, MeshPlan(1, 1, 1, ("tp", "sp"), (2, 1))))
    cache = build_model(cfg).init_cache(1, 8, device="cpu", runtime=Runtime(tensor=tp))
    assert tuple(cache["k"].shape) == (cfg.num_layers, 1, 8, 1, cfg.head_dim)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    for arch in ("hymba-1.5b", "internvl2-2b", "moonshot-v1-16b-a3b", "rwkv6-1.6b",
                 "seamless-m4t-medium"):
        cfg = get_reduced(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        for rt in (Runtime(tensor=object()), Runtime(sequence=object())):
            batch = {"tokens": toks, "patch_embeds": torch.zeros((1, 8, cfg.d_model)),
                     "frames": torch.zeros((1, 4, cfg.d_model))}
            with pytest.raises(NotImplementedError, match="item 11\\(b\\)"):
                model.prefill(params, batch, 8, rt)
            with pytest.raises(NotImplementedError, match="item 11\\(b\\)"):
                model.decode_step(params, {"pos": 4}, toks[:, :1], rt)
            with pytest.raises(NotImplementedError, match="item 11\\(b\\)"):
                model.init_cache(1, 8, device="cpu", runtime=rt)
            if cfg.family.value in ("hybrid", "vlm", "moe"):
                with pytest.raises(NotImplementedError, match="item 11\\(b\\)"):
                    tf.forward_hidden(params, cfg, tokens=toks, runtime=rt)
    moe = get_config("mixtral-8x7b")
    with pytest.raises(NotImplementedError, match="expert axis.*item 11\\(b\\)"):
        TensorParallel.from_rules(rules_at(moe, mesh_plan(moe, 256)))