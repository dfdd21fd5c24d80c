"""Rank-side pieces of the tensor-parallel CPU tests
(``test_torch_tp_*.py``).

The ranks of a ``repro_torch.dist.world.World`` import this module by
name and never JAX: the test process runs the JAX side and hands the
ranks numpy inputs and the port's whole state. A split is (client, zero,
tp, sp): the ``MeshPlan`` of that model split, which ``plan_for`` gives
only the production pool, built directly as the JAX dataclass allows.
"""
import dataclasses

import numpy as np
import torch
from _dist_cases import Replay


def torch_cfg(arch: str, over: dict | None = None):
    """The reduced config in float32 end to end, with ``over`` replaced."""
    from repro_torch.configs import get_reduced

    cfg = get_reduced(arch, param_dtype="float32", compute_dtype="float32")
    return dataclasses.replace(cfg, **(over or {}))


def split_rules(ctx, cfg, split):
    from repro_torch.dist import make_rules
    from repro_torch.dist.meshes import MeshPlan

    client, zero, t, s = split
    plan = MeshPlan(num_pods=1, num_clients=client, zero=zero, model_axes=("tp", "sp"),
                    model_split=(t, s))
    return make_rules(None, cfg, plan=plan, backend=ctx.backend, device=ctx.device)


def _np(t):
    return t.detach().cpu().numpy()


def shapes_by_path(params) -> dict:
    """{"layers/wq": shape, ...} of a parameter tree."""
    from repro_torch.dist.tensor_parallel import _paths

    from repro_torch import tree

    return {"/".join(p): tuple(x.shape) for p, x in zip(_paths(params), tree.leaves(params))}


def rank_layer(ctx, spec: dict) -> dict:
    """One sharded layer on this rank's blocks of ``spec["params"]`` (the
    JAX package's whole tree, numpy): ``"attn"`` (layer 0's attention
    block on ``x``), ``"mlp"`` (its gated MLP on ``x``) or ``"loss"``
    (the whole training loss on ``tokens``). The output (or loss), the
    input's gradient of Σ output·``cot`` and the parameters' gradient,
    gathered whole."""
    from repro_torch import convert, tree
    from repro_torch.dist.tensor_parallel import TensorParallel
    from repro_torch.models import Runtime, build_model
    from repro_torch.models import transformer as tf

    cfg = torch_cfg(spec["arch"], spec.get("over"))
    rules = split_rules(ctx, cfg, spec["split"])
    tp = TensorParallel.from_rules(rules)
    blocks = convert.shard_params(cfg, spec["params"], rules, device=ctx.device)
    leaves = [x.requires_grad_(True) for x in tree.leaves(blocks)]
    params = tree.unflatten(blocks, leaves)
    with torch.enable_grad():
        if spec["layer"] == "loss":
            toks = torch.from_numpy(spec["tokens"])
            out = build_model(cfg).loss(params, {"tokens": toks}, Runtime(tensor=tp))
            obj, x = out, None
        else:
            x = torch.from_numpy(spec["x"]).requires_grad_(True)
            lp = tf._tp_layers(params, tp)[0]
            if spec["layer"] == "attn":
                pos = torch.arange(x.shape[1])
                w, theta = tf.static_layer_meta(cfg, 0)
                out, _ = tf._attn_block(lp, cfg, x, pos, w, theta, Runtime(tensor=tp))
            else:
                out = tf.layer_ffn(lp, cfg, x, Runtime(tensor=tp))
            obj = torch.sum(out * torch.from_numpy(spec["cot"]))
        grads = torch.autograd.grad(obj, leaves + ([x] if x is not None else []),
                                    allow_unused=True, materialize_grads=True)
    whole = tp.gather_tree(tree.unflatten(blocks, list(grads[:len(leaves)])))
    return dict(out=_np(out), grad_x=None if x is None else _np(grads[-1]),
                grads=[_np(g) for g in tree.leaves(whole)],
                local_shapes=shapes_by_path(blocks), blocks=[_np(x) for x in leaves])


def rank_tp_round(ctx, spec: dict) -> dict:
    """The tensor-parallel LM round on this rank over ``spec["batches"]``
    from the port's whole ``spec["state"]`` (its blocks taken here), with
    the recorded draws; each round's contract asserted on the rank's
    ledger. Returns the whole final state (gathered over the model
    group), the metrics, the ledger's counts, this rank's block shapes
    and slot rows."""
    from repro_torch import tree
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.dist import (
        CollectiveLog,
        assert_inter_client_contract,
        count_axis_crossing,
    )
    from repro_torch.dist.collectives import tensor_axis_summary
    from repro_torch.dist.tensor_parallel import TensorParallel
    from repro_torch.fl import FLConfig, make_round_fn
    from repro_torch.fl.state import rank_state, whole_state
    from repro_torch.launch.train import host_metrics
    from repro_torch.models import build_model

    cfg = torch_cfg(spec["arch"])
    model = build_model(cfg)
    fl = FLConfig(scheduler=SchedulerConfig(theta_d=0.5), **spec["fl"])
    rules = split_rules(ctx, cfg, spec["split"])
    tp = TensorParallel.from_rules(rules)
    fn = make_round_fn(model, fl, flops_per_client_round=1e9, rules=rules,
                       draws=Replay(spec["calls"]))
    p = model.param_count()
    mesh = rules.mesh
    state = rank_state(spec["state"], tp)
    shapes = shapes_by_path(state.params)
    out = dict(metrics=[], contract=[], zero_ops=[], tensor=[])
    for b in spec["batches"]:
        batch = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
        with CollectiveLog() as log, torch.no_grad():
            state, m = fn(state, batch)
        out["contract"].append(assert_inter_client_contract(log, rules, p, fl.fog_nodes)[0])
        out["zero_ops"].append(count_axis_crossing(
            log, mesh, axes=("zero",), kinds=("all-reduce",), not_axes=("client", "tp", "sp"),
            min_bytes=4.0 * p / rules.tensor_ways / 2))
        out["tensor"].append(tensor_axis_summary(log, rules, 1))
        out["metrics"].append(host_metrics(m))
    out.update(state=whole_state(state, tp), local_shapes=shapes,
               mu_shapes=None if state.server_mu is None else
               [tuple(x.shape) for x in tree.leaves(state.server_mu)],
               slots=rules.slot_range(fl.slots), coords=mesh.coords)
    return out


def rank_checkpoint(ctx, spec: dict) -> dict:
    """A rank's blocks of ``spec["state"]`` saved whole (rank 0 writes
    ``spec["dir"]``), then restored into its blocks: whether each block
    comes back equal, and the blocks' shapes."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import tree
    from repro_torch.dist.tensor_parallel import TensorParallel
    from repro_torch.fl.state import rank_state, whole_state

    cfg = torch_cfg(spec["arch"])
    rules = split_rules(ctx, cfg, spec["split"])
    tp = TensorParallel.from_rules(rules)
    state = rank_state(spec["state"], tp)
    whole = whole_state(state, tp)
    if ctx.rank == 0:
        ckpt.save(spec["dir"], 3, whole)
    torch.distributed.barrier()
    back = ckpt.restore_rank(spec["dir"], 3, state, tp)
    same = all(torch.equal(a, b) for a, b in zip(
        tree.leaves([state.params, state.server_mu]), tree.leaves([back.params, back.server_mu])))
    return dict(same=same, step=back.step, rng=np.asarray(back.rng),
                shapes=[tuple(x.shape) for x in tree.leaves(back.params)])
