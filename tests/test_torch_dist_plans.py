"""The port's mesh plans and sharding rules (``repro_torch.dist.meshes``,
``sharding``) against the JAX package's, as arithmetic.

  * ``plan_for`` / ``MeshPlan`` equal to JAX's (every field and derived
    axis) and ``make_rules``' specs equal to JAX's PartitionSpecs compared
    as tuples (parameters plain, stacked and without FSDP, optimizer
    moments, the fused delta buffer, train and serve batches of every
    shape, decode caches) for the ten configs × {single pod, multi-pod} ×
    {production, ``device_count`` 8 and 16};
  * the cases of ``tests/test_dist.py`` (scaled plans, multi-pod axes, the
    MoE expert axis, divisibility fallbacks, FSDP off, the stacked client
    axis) and ``tests/test_sharding_rules.py`` (every spec divides its dim);
  * what the port adds: the axis sets the round reduces over and their
    rank groups, a rank's slot and batch rows, the device of every rank
    and the routes it refuses; ``split_fog_axes`` against JAX's, its error
    included.
"""
import dataclasses
import types

import jax
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced_config
from repro.configs.shapes import SHAPES, batch_specs, cache_specs
from repro.dist import plan_for as jax_plan_for
from repro.dist.sharding import ShardingRules as JaxRules
from repro.kernels.delta_pipeline.sharded import split_fog_axes as jax_split
from repro.models import build_model as jax_build
from repro_torch.configs import get_config, get_reduced
from repro_torch.dist import make_rules, plan_for
from repro_torch.dist.meshes import Mesh, MeshPlan, axis_groups, rank_devices
from repro_torch.dist.sharding import ShardingRules
from repro_torch.kernels.delta_pipeline.sharded import split_fog_axes
from repro_torch.models.api import decls
from repro_torch.models.params import _leaves

SCALES = [None, 8, 16]  # production, device_count 8 and 16


def _fake_mesh(shape: dict):
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _both_rules(arch, multi_pod, device_count):
    jplan = jax_plan_for(jax_config(arch), multi_pod=multi_pod, device_count=device_count)
    plan = plan_for(get_config(arch), multi_pod=multi_pod, device_count=device_count)
    mesh = _fake_mesh(plan.shape)
    jr = JaxRules.__new__(JaxRules)
    for k, v in (("cfg", jax_config(arch)), ("plan", jplan), ("mesh", mesh)):
        object.__setattr__(jr, k, v)
    return jplan, plan, jr, ShardingRules(get_config(arch), plan, mesh)


def _specs(tree_of_p):
    return [tuple(s) for s in jax.tree.flatten(tree_of_p, is_leaf=lambda x: isinstance(x, P))[0]]


def _port_specs(spec_tree, decl_tree):
    out = []
    for path, _ in _leaves(decl_tree):
        node = spec_tree
        for k in path:
            node = node[k]
        out.append(node)
    return out


@pytest.mark.parametrize("device_count", SCALES, ids=["production", "8", "16"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multi-pod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plans_and_specs_match_jax(arch, multi_pod, device_count):
    jplan, plan, jr, tr = _both_rules(arch, multi_pod, device_count)
    for f in ("num_pods", "num_clients", "zero", "model_axes", "model_split", "fsdp_params",
              "multi_pod", "client_axes", "data_axes", "axis_names", "axis_sizes",
              "device_count"):
        assert getattr(plan, f) == getattr(jplan, f), f
    assert plan.shape == dict(jplan.shape)
    for f in ("batch_axes", "client_ways", "serve_batch_axes"):
        assert getattr(tr, f) == getattr(jr, f), f
    for p_total in (None, 1_000_000, 1_000_001):
        for shard_p in (True, False):
            assert tr.fused_delta_spec(p_total, shard_p=shard_p) == tuple(
                jr.fused_delta_spec(p_total, shard_p=shard_p))
    jm = jax_build(jax_config(arch))
    shapes, laxes = jm.param_shapes(), jm.param_axes()
    d = decls(get_config(arch))
    for kw in (dict(), dict(stacked=True), dict(fsdp=False), dict(stacked=True, fsdp=False)):
        assert _port_specs(tr.param_specs(d, **kw), d) == _specs(
            jr.param_specs(shapes, laxes, **kw)), kw
    assert _port_specs(tr.opt_spec_tree(d, stacked=True), d) == _specs(
        jr.opt_spec_tree(shapes, laxes, stacked=True))
    cfg = jax_config(arch)
    for name, shape in SHAPES.items():
        bspecs = batch_specs(cfg, shape)
        dims = {k: tuple(v.shape) for k, v in bspecs.items()}
        for port_fn, jax_fn in ((tr.train_batch_specs, jr.train_batch_specs),
                                (tr.serve_batch_specs, jr.serve_batch_specs)):
            assert port_fn(dims) == {k: tuple(v) for k, v in jax_fn(bspecs).items()}, name
        if shape.kind == "decode":
            leaves = jax.tree.leaves(cache_specs(jm, shape))
            assert tr.cache_specs(leaves) == _specs(jr.cache_specs(leaves)), name


# ---- tests/test_dist.py's plan and rule cases ------------------------ #
def test_scaled_plan_arithmetic():
    cfg = get_config("llama3.2-1b")
    plan = plan_for(cfg, device_count=8)
    assert plan.device_count == 8
    assert plan.num_clients * plan.zero == 8
    assert plan.model_split == (1, 1)
    assert plan.client_axes == ("client",)
    assert plan.data_axes == ("client", "zero")
    plan = plan_for(cfg, device_count=8, zero=4)
    assert plan.zero == 4 and plan.num_clients == 2
    with pytest.raises(ValueError):
        plan_for(cfg, device_count=8, zero=3)
    with pytest.raises(ValueError):
        plan_for(cfg, device_count=7, multi_pod=True)


def test_multi_pod_plan_axes():
    plan = plan_for(get_config("qwen2.5-14b"), multi_pod=True)
    assert plan.axis_names[0] == "pod" and plan.shape["pod"] == 2
    assert plan.device_count == 512
    assert plan.client_axes == ("pod", "client")
    assert plan.model_axes == ("tp", "sp") and plan.model_split == (8, 2)


def test_moe_plan_expert_axis():
    plan = plan_for(get_config("mixtral-8x7b"))
    assert plan.model_axes == ("expert", "tp") and plan.model_split == (8, 2)
    assert plan_for(get_config("moonshot-v1-16b-a3b")).model_split == (16, 1)


def _production_rules(arch):
    plan = plan_for(get_config(arch))
    return plan, ShardingRules(get_config(arch), plan,
                               _fake_mesh({k: v for k, v in plan.shape.items() if v > 1}))


def test_rules_divisibility_fallback():
    """GQA kv heads smaller than tp fall back to replication; every spec
    entry's axis product divides its dim."""
    plan, rules = _production_rules("yi-9b")  # 32 q heads (tp=16), 4 kv heads
    d = decls(get_config("yi-9b"))
    specs = rules.param_specs(d)
    assert specs["layers"]["wq"][2] == "tp"
    assert specs["layers"]["wk"][2] is None
    assert specs["layers"]["wq"][1] == "zero"  # FSDP: embed over zero
    for (_, decl), spec in zip(_leaves(d), _port_specs(specs, d)):
        for dim, entry in zip(decl.shape, spec):
            axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            prod = 1
            for a in axes:
                prod *= plan.shape[a]
            assert dim % prod == 0


def test_rules_serve_fsdp_off():
    """A one-rank plan builds its mesh without a process group."""
    cfg = get_reduced("llama3.2-1b")
    rules = make_rules(None, cfg, device_count=1, device="cpu")
    assert rules.mesh.rank == 0 and rules.mesh.groups == {}
    d = decls(cfg)
    assert all(all(e is None for e in s) for s in _port_specs(rules.param_specs(d, fsdp=False), d))


def test_rules_stacked_prepends_client_axis():
    _, rules = _production_rules("llama3.2-1b")
    d = decls(get_config("llama3.2-1b"))
    assert all(s[0] == "client" for s in _port_specs(rules.param_specs(d, stacked=True), d))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_arithmetic(arch):
    """``tests/test_sharding_rules.py::test_plan_arithmetic``."""
    cfg = get_config(arch)
    for multi_pod in (False, True):
        plan = plan_for(cfg, multi_pod=multi_pod)
        assert plan.num_clients * plan.zero == 16 * (2 if multi_pod else 1)
        assert plan.model_split[0] * plan.model_split[1] == 16
        if cfg.num_experts:
            assert cfg.num_experts % plan.model_split[0] == 0
        elif plan.model_split[0] > 1:
            assert cfg.num_heads % plan.model_split[0] == 0


# ---- what the port adds ------------------------------------------------ #
def test_axis_sets_and_groups():
    plan = plan_for(get_config("llama3.2-1b"), multi_pod=True, device_count=8)
    assert plan.axis_sets() == [("pod",), ("pod", "client"), ("client",), ("zero",)]
    names, sizes = plan.axis_names, plan.axis_sizes  # pod 2, client 2, zero 2
    assert axis_groups(names, sizes, ("zero",)) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert axis_groups(names, sizes, ("client",)) == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert axis_groups(names, sizes, ("pod",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert axis_groups(names, sizes, ("pod", "client")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    # the groups partition the ranks, each group along the set only
    for axes in plan.axis_sets():
        groups = axis_groups(names, sizes, axes)
        assert sorted(r for g in groups for r in g) == list(range(8))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_slot_and_batch_rows(multi_pod):
    cfg = get_reduced("llama3.2-1b")
    plan = plan_for(cfg, multi_pod=multi_pod, device_count=8)
    seen = []
    for rank in range(8):
        mesh = Mesh(plan.axis_names, plan.axis_sizes, rank, torch.device("cpu"), "gloo")
        rules = ShardingRules(cfg, plan, mesh)
        c = mesh.coords
        client_index = (c.get("pod", 0) * plan.shape["client"] + c["client"])
        assert rules.slot_range(8) == (2 * client_index, 2 * client_index + 2)
        assert rules.batch_range(6) == (3 * c["zero"], 3 * c["zero"] + 3)
        seen.append((rules.slot_range(8), rules.batch_range(6)))
    assert len(set(seen)) == 8  # every rank its own (slots, share)
    with pytest.raises(ValueError, match="slots"):
        rules.slot_range(6)
    with pytest.raises(ValueError, match="batch rows"):
        rules.batch_range(5)


def test_rank_devices_and_refused_routes(monkeypatch):
    assert rank_devices("gloo", 4, "cpu") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="nccl"):
        rank_devices("nccl", 2, "cpu")
    with pytest.raises(ValueError, match="backend"):
        rank_devices("mpi", 2, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rank_devices("gloo", 2, "cuda") == [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="one card per rank"):
        rank_devices("nccl", 2, "cuda")  # two ranks on one card: refused, not switched
    assert rank_devices("nccl", 1, "cuda") == [torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        rank_devices("gloo", 2, "cuda")


def test_build_mesh_needs_a_world():
    plan = plan_for(get_reduced("llama3.2-1b"), device_count=8)
    with pytest.raises(RuntimeError, match="initialize"):
        plan.build_mesh("gloo", "cpu")
    with pytest.raises(ValueError, match="axes"):
        make_rules(_fake_mesh({"client": 8}), get_reduced("llama3.2-1b"), device_count=8)


@pytest.mark.parametrize("shape,fog", [
    ({"pod": 2, "client": 2, "zero": 2}, 2),
    ({"pod": 2, "client": 2, "zero": 2}, 4),
    ({"pod": 2, "client": 2, "zero": 2}, 1),
    ({"client": 4, "zero": 2}, 4),
    ({"pod": 2, "client": 1, "zero": 4}, 2),
])
def test_split_fog_axes_matches_jax(shape, fog):
    mesh = _fake_mesh(shape)
    axes = tuple(a for a in ("pod", "client") if a in shape)
    assert split_fog_axes(mesh, axes, fog) == jax_split(mesh, axes, fog)


@pytest.mark.parametrize("shape,fog", [({"client": 4, "zero": 2}, 2),
                                       ({"pod": 2, "client": 2, "zero": 2}, 3)])
def test_split_fog_axes_error(shape, fog):
    mesh = _fake_mesh(shape)
    axes = tuple(a for a in ("pod", "client") if a in shape)
    with pytest.raises(ValueError, match="leading prefix") as port:
        split_fog_axes(mesh, axes, fog)
    with pytest.raises(ValueError) as ref:
        jax_split(mesh, axes, fog)
    assert str(port.value) == str(ref.value)


def test_reduced_configs_plan_like_jax():
    """The plans the CPU tests and the launcher execute."""
    for arch in ARCH_IDS:
        for n, multi_pod in ((2, False), (4, False), (8, False), (4, True), (8, True)):
            got = plan_for(get_reduced(arch), device_count=n, multi_pod=multi_pod)
            want = jax_plan_for(jax_reduced_config(arch), device_count=n, multi_pod=multi_pod)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
