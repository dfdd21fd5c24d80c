"""Rank-side pieces of the serving-under-rules CPU tests
(``test_torch_serve_dist*.py``).

The ranks of a ``repro_torch.dist.world.World`` import this module by
name and never JAX: the test process runs the JAX side and hands the
ranks the JAX parameters (numpy) and the inputs. A case names its plan
by ``split`` (client, zero, tp, sp): the ``MeshPlan`` of that model split,
built directly; or by None: ``plan_for(device_count=world size)``, the
scaled plan (client × zero, no model axes).
"""
import dataclasses

import numpy as np
import torch


def case_config(arch: str, over: dict | None = None):
    """The reduced config in float32 end to end (``loss_chunk=0``), with
    ``over`` replaced."""
    from repro_torch.configs import get_reduced

    cfg = get_reduced(arch, loss_chunk=0, param_dtype="float32", compute_dtype="float32")
    return dataclasses.replace(cfg, **(over or {}))


def case_rules(ctx, cfg, split):
    from repro_torch.dist import make_rules, plan_for
    from repro_torch.dist.meshes import MeshPlan

    if split is None:
        plan = plan_for(cfg, device_count=ctx.world_size)
    else:
        client, zero, t, s = split
        plan = MeshPlan(num_pods=1, num_clients=client, zero=zero, model_axes=("tp", "sp"),
                        model_split=(t, s))
    return make_rules(None, cfg, plan=plan, backend=ctx.backend, device=ctx.device)


def case_params(cfg, params, rules):
    """This rank's blocks (a model split) or the whole tree of the JAX
    parameters, on the CPU."""
    from repro_torch import convert

    if rules.tensor_ways > 1:
        return convert.shard_params(cfg, params, rules, device="cpu")
    return convert.model_params_from_jax(cfg, params, device="cpu")


def whole(logits, runtime, layout, rules):
    """A rank's (rows, V_local) logits -> the whole (B, V), numpy."""
    from repro_torch.dist.serve_selftest import _whole_logits

    return _whole_logits(logits, runtime, layout, rules.mesh).numpy()


def _batch(spec):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in spec["batch"].items()}


def rank_prefill_decode(ctx, spec: dict) -> dict:
    """The model's ``prefill`` of ``spec["batch"]`` and ``spec["steps"]``
    greedy ``decode_step`` s on this rank's share (``serve.static.
    serve_runtime``, the rows of ``ServeLayout``). Returns every step's
    whole logits, the tokens, the layout, the census of one decode step
    and the cache block's shape."""
    from repro_torch.models import build_model
    from repro_torch.models.transformer import greedy
    from repro_torch.serve.static import decode_census, serve_runtime

    cfg = case_config(spec["arch"], spec.get("over"))
    rules = case_rules(ctx, cfg, spec.get("split"))
    params = case_params(cfg, spec["params"], rules)
    model = build_model(cfg)
    batch = _batch(spec)
    b, s = batch["tokens"].shape
    runtime = serve_runtime(rules, b, s)
    layout = rules.serve_layout(b, s)
    lo, hi = layout.rows
    local = {k: v[lo:hi] for k, v in batch.items()}
    logits_all, toks_all = [], []
    with torch.no_grad():
        logits, cache = model.prefill(params, local, cache_len=spec["cache_len"],
                                      runtime=runtime)
        shape = tuple(cache["k"].shape)
        for i in range(spec["steps"] + 1):
            logits_all.append(whole(logits[:, -1], runtime, layout, rules))
            tok = greedy(logits[:, -1], runtime)[:, None]
            toks_all.append(whole(tok.double(), dataclasses.replace(runtime, tensor=None),
                                  layout, rules)[:, 0].astype(np.int64))
            if i < spec["steps"]:
                logits, cache = model.decode_step(params, cache, tok, runtime)
        census = decode_census(model, params, hi - lo, spec["cache_len"], s, runtime,
                               ctx.device)
    return dict(logits=logits_all, tokens=np.stack(toks_all, axis=1), kind=layout.kind,
                rows=layout.rows, span=cache.get("span"), cache_shape=shape,
                census=census.count_by_kind)


def rank_static(ctx, spec: dict) -> dict:
    """``serve.static.serve_static`` of ``spec["batch"]`` under the case's
    rules: the whole batch's tokens, the first decode step's whole
    logits, the layout and the census."""
    from repro_torch.models import build_model
    from repro_torch.serve.static import decode_census, serve_runtime, serve_static

    cfg = case_config(spec["arch"], spec.get("over"))
    rules = case_rules(ctx, cfg, spec.get("split"))
    params = case_params(cfg, spec["params"], rules)
    model = build_model(cfg)
    batch = _batch(spec)
    b, s = batch["tokens"].shape
    layout = rules.serve_layout(b, s)
    runtime = serve_runtime(rules, b, s)
    census = decode_census(model, params, layout.rows[1] - layout.rows[0], spec["cache_len"],
                           s, runtime, ctx.device)
    res = serve_static(model, params, batch, spec["cache_len"], spec["gen"], rules=rules,
                       keep_logits=True)
    return dict(tokens=res.tokens, first=whole(res.first_logits, runtime, layout, rules),
                kind=layout.kind, rows=res.rows, census=census.count_by_kind)


def rank_continuous(ctx, spec: dict) -> dict:
    """``ContinuousBatchingEngine`` under the case's rules (its ``attn``
    mode) on the trace of host arrays ``spec["trace"]``: every request's
    tokens, the report's counts and the census of one decode step."""
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousBatchingEngine, EngineConfig, trace_from_arrays
    from repro_torch.serve.static import serve_runtime

    cfg = case_config(spec["arch"], spec.get("over"))
    rules = case_rules(ctx, cfg, spec.get("split"))
    params = case_params(cfg, spec["params"], rules)
    engine = ContinuousBatchingEngine(build_model(cfg), params, EngineConfig(**spec["ecfg"]),
                                      runtime=serve_runtime(rules))
    census = engine.decode_collectives()
    rep = engine.serve(trace_from_arrays(**spec["trace"]))
    return dict(tokens=[rep.tokens_for(r) for r in range(rep.n_requests)],
                completed=rep.completed, rejected=rep.rejected,
                decode_steps=rep.decode_steps, census=census.count_by_kind,
                kv_heads=tuple(engine_pool_heads(engine)))


def engine_pool_heads(engine):
    from repro_torch.serve.paged import init_pool

    pool = init_pool(engine.model.cfg, engine.plan, 1, 1, device="cpu",
                     runtime=engine.runtime)
    return pool["k"].shape[-2:]
