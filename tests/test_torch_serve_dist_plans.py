"""Serving under mesh rules as arithmetic, without a world:

  * ``launch/serve.py``'s plan (``serve_plan``) and its decode-path weight
    specs (``param_specs(..., fsdp=False)``) against the JAX launcher's
    (``repro/launch/serve.py:107–138``: the scaled ``make_rules`` at
    ``--devices 8``, the production plan at 256, and at 512 with
    ``--multi-pod``) for every config, assigned and reduced, without
    executing the production plans;
  * ``ShardingRules.serve_layout``: batch rows, the prompt span and the
    cache span (even and uneven), and the replicated fallback, against
    ``serve_batch_specs``; a rank's cache block under the sequence split
    and its cache and pool blocks under a model split (the kv heads its
    query heads read, whole ``head_dim``);
  * what the mesh path refuses before any rank starts: MoE under rules,
    another family than DENSE on a model split or a sequence split,
    ``--devices`` without ``--scale full``.
"""
import argparse
import types

import jax
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.dist import plan_for as jax_plan_for
from repro.dist.sharding import ShardingRules as JaxRules
from repro.models import build_model as jax_build
from repro_torch.configs import get_reduced
from repro_torch.dist.meshes import Mesh, MeshPlan
from repro_torch.dist.sharding import ShardingRules, ceil_span, even_span
from repro_torch.dist.tensor_parallel import SequenceParallel, TensorParallel
from repro_torch.launch import serve as launch
from repro_torch.models import Runtime, build_model
from repro_torch.models.api import decls
from repro_torch.serve import paged
from repro_torch.serve.static import serve_runtime

FIELDS = ("num_pods", "num_clients", "zero", "model_axes", "model_split", "fsdp_params")


def jax_launcher_plan(cfg, devices: int, multi_pod: bool):
    """The JAX launcher's plan: scaled at ``--devices`` other than 256 a
    pod, else the production plan."""
    pods = 2 if multi_pod else 1
    if devices and devices != 256 * pods:
        return jax_plan_for(cfg, multi_pod=multi_pod, device_count=devices)
    return jax_plan_for(cfg, multi_pod=multi_pod)


def rules_at(cfg, plan, rank: int = 0) -> ShardingRules:
    return ShardingRules(cfg, plan, Mesh(plan.axis_names, plan.axis_sizes, rank,
                                         torch.device("cpu"), "gloo"))


@pytest.mark.parametrize("reduced", [False, True], ids=["assigned", "reduced"])
@pytest.mark.parametrize("devices,multi_pod", [(8, False), (256, False), (512, True)],
                         ids=["8", "256", "512-multi-pod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launcher_plan_and_weight_specs_match_jax(arch, devices, multi_pod, reduced):
    args = argparse.Namespace(arch=arch, reduced=reduced, flash=False)
    cfg = launch.mesh_config(args)
    jcfg = jax_reduced(arch, loss_chunk=0) if reduced else jax_config(arch)
    plan = launch.serve_plan(cfg, devices, multi_pod)
    jplan = jax_launcher_plan(jcfg, devices, multi_pod)
    assert {f: getattr(plan, f) for f in FIELDS} == {f: getattr(jplan, f) for f in FIELDS}
    assert plan.shape == dict(jplan.shape) and plan.device_count == devices
    mesh = types.SimpleNamespace(axis_names=plan.axis_names, shape=plan.shape)
    jr = JaxRules.__new__(JaxRules)
    for k, v in (("cfg", jcfg), ("plan", jplan), ("mesh", mesh)):
        object.__setattr__(jr, k, v)
    jm = jax_build(jcfg)
    want = [tuple(s) for s in jax.tree.flatten(
        jr.param_specs(jm.param_shapes(), jm.param_axes(), stacked=False, fsdp=False),
        is_leaf=lambda x: isinstance(x, P))[0]]
    assert ShardingRules(cfg, plan, mesh).spec_list(decls(cfg), fsdp=False) == want
    # with no --devices the launcher takes the production pool
    assert launch.serve_plan(cfg, 0, multi_pod).shape == dict(
        jax_launcher_plan(jcfg, 0, multi_pod).shape)


def test_serve_layout_rows_spans_and_fallback():
    cfg = get_reduced("llama3.2-1b")
    plan = MeshPlan(1, 2, 2, ("tp", "sp"), (1, 1))  # client 2 x zero 2: 4 data ranks
    for rank in range(4):
        r = rules_at(cfg, plan, rank)
        lay = r.serve_layout(8, 16)  # the batch divides: rows
        assert lay.kind == "batch" and lay.rows == (2 * rank, 2 * rank + 2)
        assert lay.prompt_span(16) == (0, 16) and lay.cache_span(24) == (0, 24)
        lay = r.serve_layout(2, 16)  # the prompt divides: its span
        assert r.serve_batch_specs({"tokens": (2, 16)})["tokens"] == (None, ("client", "zero"))
        assert lay.kind == "sequence" and lay.rows == (0, 2)
        assert lay.prompt_span(16) == (4 * rank, 4 * rank + 4)
        assert lay.cache_span(22) == [(0, 6), (6, 12), (12, 18), (18, 22)][rank]
        seq = SequenceParallel.from_rules(r, 2, 16)
        cache = build_model(cfg).init_cache(2, 22, device="cpu", runtime=Runtime(sequence=seq))
        assert cache["span"] == lay.cache_span(22)
        assert tuple(cache["k"].shape) == (cfg.num_layers, 2, (6, 6, 6, 4)[rank],
                                           cfg.num_kv_heads, cfg.head_dim)
        assert r.serve_layout(3, 15).kind == "replicated"  # neither divides: P()
    assert ceil_span(5, 4, 3) == (5, 5)  # an empty last span
    with pytest.raises(ValueError, match="do not divide"):
        even_span(15, 4, 0)
    one = rules_at(cfg, MeshPlan(1, 1, 1, ("tp", "sp"), (2, 1)))
    assert one.serve_layout(3, 15).kind == "replicated" and one.serve_layout(3, 15).ways == 1
    assert SequenceParallel.from_rules(one, 1, 16) is None


@pytest.mark.parametrize("split,hkv", [((2, 1), 1), ((4, 1), 1), ((1, 2), 2), ((2, 2), 1)])
def test_cache_and_pool_blocks_under_a_model_split(split, hkv):
    """A rank's cache and page pool hold the kv heads its query heads read
    (the reduced llama: 4 heads over 2 kv heads), head_dim whole."""
    cfg = get_reduced("llama3.2-1b")
    tp = TensorParallel.from_rules(rules_at(cfg, MeshPlan(1, 1, 1, ("tp", "sp"), split)))
    assert tp.kv_heads == hkv
    rt = Runtime(tensor=tp)
    cache = build_model(cfg).init_cache(3, 20, device="cpu", runtime=rt)
    assert tuple(cache["k"].shape) == (cfg.num_layers, 3, 20, hkv, cfg.head_dim)
    plan = paged.PagePlan.build(cfg, 8, 4, page_size=4)
    pool = paged.init_pool(cfg, plan, 2, 6, device="cpu", runtime=rt)
    assert tuple(pool["k"].shape) == (cfg.num_layers, 7, 4, hkv, cfg.head_dim)


def _args(**kw):
    base = dict(arch="llama3.2-1b", scale="full", reduced=True, flash=False, devices=2,
                multi_pod=False, engine="static", batch=4, prompt_len=32, backend="gloo",
                device="cpu")
    return argparse.Namespace(**dict(base, **kw))


@pytest.mark.parametrize("arch,kw,match", [
    ("moonshot-v1-16b-a3b", {}, "MoE family under mesh rules.*item 11\\(b\\), step 3"),
    ("mixtral-8x7b", dict(devices=256), "MoE family under mesh rules.*item 11\\(b\\)"),
    ("hymba-1.5b", dict(devices=256), "model split.*item 11\\(b\\)"),
    ("internvl2-2b", dict(multi_pod=True, devices=512), "model split.*item 11\\(b\\)"),
    ("rwkv6-1.6b", dict(batch=1), "sequence split.*item 11\\(b\\)"),
    ("seamless-m4t-medium", dict(batch=3, devices=2), "sequence split.*item 11\\(b\\)"),
])
def test_mesh_path_refuses_what_it_does_not_execute(arch, kw, match):
    args = _args(arch=arch, **kw)
    cfg = launch.mesh_config(args)
    plan = launch.serve_plan(cfg, args.devices, args.multi_pod)
    with pytest.raises(NotImplementedError, match=match):
        launch.check_mesh(cfg, plan, args)
    with pytest.raises(NotImplementedError, match="item 11\\(b\\)"):
        launch.main(["--arch", arch, "--scale", "full", "--reduced", "--device", "cpu",
                     "--devices", str(args.devices), "--batch", str(args.batch),
                     "--prompt-len", "32"] + (["--multi-pod"] if args.multi_pod else []))


def test_mesh_path_serves_the_other_families_batch_parallel_and_moe_raises_at_ranks():
    args = _args(arch="hymba-1.5b")
    cfg = launch.mesh_config(args)
    launch.check_mesh(cfg, launch.serve_plan(cfg, 2), args)  # batch-parallel: served
    launch.check_mesh(cfg, launch.serve_plan(cfg, 2), _args(arch="hymba-1.5b",
                                                            engine="continuous", batch=1))
    moe = get_reduced("moonshot-v1-16b-a3b")
    with pytest.raises(NotImplementedError, match="item 11\\(b\\), step 3"):
        serve_runtime(rules_at(moe, launch.serve_plan(moe, 2)))
    with pytest.raises(ValueError, match="--scale full"):
        launch.main(["--devices", "2", "--device", "cpu"])


@pytest.mark.parametrize("window", [-1, 3])
@pytest.mark.parametrize("ways", [2, 4, 7])
def test_partial_decode_attentions_merge_to_the_whole(ways, window):
    """The sequence split's decode attention without a world: a cache of 6
    positions in ``ceil_span`` spans (an empty last one at 4 and 7 ways),
    each span's ``attention_decode_partial``, merged by
    ``merge_attention_partials`` with the reductions done over a list,
    equals ``attention_decode`` over the whole cache; spans past the
    position or outside the window (nothing visible) and empty spans
    weigh nothing and make no NaN."""
    from repro_torch.models.layers import (
        attention_decode,
        attention_decode_partial,
        merge_attention_partials,
    )

    gen = torch.Generator().manual_seed(ways)
    q = torch.randn((2, 1, 4, 8), generator=gen)
    k, v = (torch.randn((2, 6, 2, 8), generator=gen) for _ in range(2))
    pos = torch.tensor([4, 2])
    want = attention_decode(q, k, v, pos, window)
    spans = [ceil_span(6, ways, i) for i in range(ways)]
    parts = [attention_decode_partial(q, k[:, lo:hi], v[:, lo:hi], pos, window, lo)
             for lo, hi in spans]
    for i, (m, l, o) in enumerate(parts):
        others = [p for j, p in enumerate(parts) if j != i]

        def reduce_max(t, others=others):
            return torch.stack([t] + [p[0] for p in others]).amax(0)

        def reduce_sum(t, i=i):
            packs = []
            for j, (mj, lj, oj) in enumerate(parts):
                mg = torch.stack([p[0] for p in parts]).amax(0)
                sc = torch.exp(mj - torch.where(torch.isfinite(mg), mg, torch.zeros_like(mg)))
                scaled = (oj * sc.transpose(1, 2)[..., None]).reshape(2, 4, -1)
                packs.append(torch.cat([(lj * sc).reshape(2, 4, 1), scaled], dim=-1))
            assert torch.equal(packs[i], t)
            return torch.stack(packs).sum(0)

        got = merge_attention_partials(m, l, o, reduce_max, reduce_sum)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert any(hi == lo for lo, hi in spans) == (ways > 2)
