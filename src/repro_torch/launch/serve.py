"""Serving launcher: static batch or continuous batching (port of
``repro/launch/serve.py``), on the CUDA card unless ``--device cpu``.

    python -m repro_torch.launch.serve --arch llama3.2-1b --scale full \
        --engine continuous --attn paged --flash
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --scale full \
        --engine continuous
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --scale full \
        --engine continuous --attn paged --flash
    python -m repro_torch.launch.serve --arch hymba-1.5b --scale full \
        --engine continuous --attn paged --flash
    python -m repro_torch.launch.serve --arch seamless-m4t-medium --scale full \
        --engine static --flash --batch 8 --prompt-len 128 --gen 32

``--arch`` takes the registered architectures: llama3.2-1b, qwen2.5-14b,
yi-9b and gemma3-12b (DENSE), moonshot-v1-16b-a3b and mixtral-8x7b (MOE,
the dropless FFN of ``models/moe.py``; mixtral's 93 GB do not fit one
80 GB card at full scale), rwkv6-1.6b (SSM, prefill through K6),
hymba-1.5b (HYBRID: attention beside an SSM branch), internvl2-2b (VLM:
8 random patch embeddings prepended to each prompt) and
seamless-m4t-medium (ENCDEC: ``--prompt-len`` random source frames and
as many target tokens; the static engine only, as in the JAX launcher).
``--scale tiny`` runs the reduced config, ``--scale full`` the assigned
one on one device. Engines:

  * ``--engine static`` (default) — one fixed batch, prefill + N decode
    steps; greedy tokens accumulate in a device buffer read once at the
    end;
  * ``--engine continuous`` — the slot-scheduled engine (``repro_torch.
    serve``): Poisson arrivals off the event queue, mid-flight slot
    eviction and refill, §IV.F latency/energy/cold-start accounting, and
    ``--attn paged`` for K7 (``--attn dense`` reproduces the sequential
    per-request decode token for token).

``--flash`` sets ``attn_impl="flash"``: prefill through K5. For rwkv6,
which has no attention, ``--flash`` and ``--attn`` have no effect, as in
the JAX launcher. ``--track SPEC --track-every K`` (SPEC ``jsonl:PATH``,
``csv:PATH``, ``noop``, comma-separated to compose) streams one row per
K decode steps of either engine through ``repro_torch.obs``.

Mesh rules, as in the JAX launcher: ``--scale full`` with ``--devices
N``, ``--multi-pod`` or ``--reduced`` serves on a world of ranks
(``torch.distributed``, ``--backend gloo|nccl``; nccl needs a card per
rank). The plan is ``launch.train.mesh_plan``'s: the production plan at
256 devices a pod (512 with ``--multi-pod``, also when ``--devices`` is
not given), tensor axes included, else the scaled host plan; ``--reduced``
serves the reduced config on it. Each rank holds its blocks of the
weights (``param_specs(..., fsdp=False)``: no zero split on the decode
path), the static engine splits the batch's rows over the data axes, or
the prompt's positions where the rows do not divide (DENSE), and the
continuous engine runs the whole trace on every data replica, on the
rank's heads under a model split (``serve.static``, ``serve.engine``).
The plan and the decode step's collective census are printed first:

    python -m repro_torch.launch.serve --scale full --devices 2 --reduced --device cpu
    python -m repro_torch.launch.serve --scale full --devices 2 --reduced --device cpu \
        --batch 1 --prompt-len 32                     # the sequence split
    python -m repro_torch.launch.serve --scale full --devices 2 --reduced --device cpu \
        --engine continuous --attn paged --flash

MoE under rules, and the other families on a model or sequence split,
raise (ROADMAP.md queue 1, item 11(b)).
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--scale", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--engine", default="static", choices=["static", "continuous"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to ask for the CPU)")
    ap.add_argument("--flash", action="store_true",
                    help="prefill attention through K5 (attn_impl='flash')")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=0,
                    help="with --scale full: serve on N ranks (256, or 512 with "
                         "--multi-pod: the production plan)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="with --scale full: the reduced config on the mesh plan")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="the ranks' torch.distributed backend under mesh rules")
    ap.add_argument("--requests", type=int, default=16,
                    help="trace length for --engine continuous")
    ap.add_argument("--rate", type=float, default=20.0,
                    help="mean request arrival rate (per virtual second)")
    ap.add_argument("--slots", type=int, default=0, help="slot count (default: --batch)")
    ap.add_argument("--slo-ms", type=float, default=4000.0)
    ap.add_argument("--attn", default="dense", choices=["dense", "paged"])
    ap.add_argument("--policy", default="fifo", choices=["fifo", "edf"])
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--track", default=None,
                    help="tracker spec, e.g. jsonl:/tmp/serve.jsonl")
    ap.add_argument("--track-every", type=int, default=1)
    args = ap.parse_args(argv)
    if args.devices or args.multi_pod or args.reduced:
        return _run_mesh(args)

    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import build_model

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.scale == "full" else get_reduced(args.arch)
    if args.flash:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen)

    tap = None
    if args.track:
        from repro_torch.obs import MetricTap, tracker_from_spec

        tap = MetricTap(tracker_from_spec(args.track), every=args.track_every,
                        const={"arch": cfg.name}, channel="serve")
    try:
        if args.engine == "continuous":
            return _run_continuous(args, cfg, model, params, device, tap)
        return _run_static(args, cfg, model, params, device, tap)
    finally:
        if tap is not None:
            tap.tracker.finish()


def mesh_config(args):
    """The config of the mesh path: the assigned one, or with ``--reduced``
    the reduced one (``loss_chunk=0``, as the JAX launcher builds it);
    ``--flash`` sets ``attn_impl="flash"``."""
    from repro_torch.configs import get_config, get_reduced

    cfg = get_reduced(args.arch, loss_chunk=0) if args.reduced else get_config(args.arch)
    return dataclasses.replace(cfg, attn_impl="flash") if args.flash else cfg


def serve_plan(cfg, devices: int = 0, multi_pod: bool = False):
    """The mesh plan of ``--devices`` (0: the production pool, 256 devices
    a pod), by ``launch.train.mesh_plan``'s rule (JAX ``launch/serve.py``
    ``:107–129``)."""
    from repro_torch.dist.meshes import DATA_PER_POD, MODEL_PER_POD
    from repro_torch.launch.train import mesh_plan

    pods = 2 if multi_pod else 1
    return mesh_plan(cfg, devices or DATA_PER_POD * MODEL_PER_POD * pods, multi_pod)


def check_mesh(cfg, plan, args) -> None:
    """Refuse, before any rank starts, what the mesh path does not execute
    (ROADMAP.md queue 1, item 11(b)): MoE under rules, another family than
    DENSE on a model split or (static engine) a sequence split."""
    import torch

    from repro_torch.dist.meshes import Mesh
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.models import Family
    from repro_torch.serve.static import _MOE

    if cfg.num_experts:
        raise NotImplementedError(f"{cfg.name}: {_MOE}")
    if cfg.family is Family.DENSE:
        return
    if plan.model_ways > 1:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family on a model split {plan.shape} is "
            "not executed yet; DENSE only: ROADMAP.md queue 1, item 11(b)")
    rules = ShardingRules(cfg, plan, Mesh(plan.axis_names, plan.axis_sizes, 0,
                                          torch.device("cpu"), args.backend))
    if args.engine == "static" and rules.serve_layout(args.batch,
                                                      args.prompt_len).kind == "sequence":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family.value} family on a sequence split (batch "
            f"{args.batch} does not divide the data axes) is not executed yet; DENSE only: "
            "ROADMAP.md queue 1, item 11(b)")


def _run_mesh(args):
    """The mesh path: the plan printed, ``plan.device_count`` ranks spawned
    (``serve_rank``); returns rank 0's result."""
    if args.scale != "full":
        raise ValueError("--devices, --multi-pod and --reduced take --scale full "
                         "(the mesh path, as in the JAX launcher)")
    from repro_torch.device import resolve_device
    from repro_torch.dist.world import spawn

    cfg = mesh_config(args)
    plan = serve_plan(cfg, args.devices, args.multi_pod)
    check_mesh(cfg, plan, args)
    device = resolve_device(args.device)
    print(f"[serve] mesh plan: {plan.shape}", flush=True)
    return spawn(serve_rank, plan.device_count, vars(args), backend=args.backend,
                 device=device, timeout=3600.0)[0]


def serve_rank(ctx, opts: dict):
    """One rank of the mesh path (``dist.world.RankContext`` ``ctx``, the
    launcher's options): the rules, the rank's blocks of the weights drawn
    from ``--seed`` (every rank draws the whole tree, then keeps its
    blocks), and the engine; rank 0 prints and returns the result, the
    others None."""
    import torch

    from repro_torch.dist import make_rules
    from repro_torch.models import build_model

    args = argparse.Namespace(**opts)
    cfg = mesh_config(args)
    plan = serve_plan(cfg, args.devices, args.multi_pod)
    rules = make_rules(None, cfg, plan=plan, backend=ctx.backend, device=ctx.device)
    model = build_model(cfg)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(args.seed)
    params = model.init(gen, rules)
    tap = None
    if args.track and ctx.rank == 0:
        from repro_torch.obs import MetricTap, tracker_from_spec

        tap = MetricTap(tracker_from_spec(args.track), every=args.track_every,
                        const={"arch": cfg.name}, channel="serve")
    try:
        run = _run_continuous if args.engine == "continuous" else _run_static
        out = run(args, cfg, model, params, ctx.device, tap, rules)
    finally:
        if tap is not None:
            tap.tracker.finish()
    return out if ctx.rank == 0 else None


def _run_static(args, cfg, model, params, device, tap, rules=None):
    import torch

    from repro_torch.serve.static import decode_census, serve_runtime, serve_static

    batch, cache_len = static_batch(cfg, args.batch, args.prompt_len, args.gen,
                                    args.seed, device)
    show = rules is None or rules.mesh.rank == 0
    if rules is not None:
        from repro_torch.dist.collectives import census_line

        layout = rules.serve_layout(args.batch, args.prompt_len)
        stats = decode_census(model, params, layout.rows[1] - layout.rows[0], cache_len,
                              args.prompt_len, serve_runtime(rules, args.batch,
                                                             args.prompt_len), device)
        if show:
            print(f"[serve] layout: {layout.kind} over {layout.axes} "
                  f"(rows {layout.rows} of rank 0)", flush=True)
            print(census_line(stats), flush=True)
    res = serve_static(model, params, batch, cache_len, args.gen, rules=rules, tap=tap)
    if show:
        print(f"arch={cfg.name} device={device} prefill={res.prefill_ms:.1f}ms "
              f"decode={res.decode_ms:.2f}ms/tok")
        print("generated token ids (first row):", res.tokens[0].tolist())
    return torch.from_numpy(res.tokens)


def static_batch(cfg, batch: int, prompt_len: int, gen: int, seed: int, device):
    """The static engine's prefill batch and cache length: random prompts
    (batch, prompt_len); a VLM config's 8 patch embeddings per row, which
    the cache holds too; an ENCDEC config's (batch, prompt_len, d) source
    frames. Drawn on ``device`` from ``seed + 1``."""
    import torch

    from repro_torch.models import Family

    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    dtype = getattr(torch, cfg.compute_dtype)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=g,
                                   device=device)}
    cache_len = prompt_len + gen
    if cfg.family is Family.VLM:
        out["patch_embeds"] = torch.randn((batch, 8, cfg.d_model), generator=g,
                                          device=device).to(dtype)
        cache_len += 8
    if cfg.family is Family.ENCDEC:
        out["frames"] = torch.randn((batch, prompt_len, cfg.d_model), generator=g,
                                    device=device).to(dtype)
    return out, cache_len


def _run_continuous(args, cfg, model, params, device, tap, rules=None):
    from repro_torch.models import Runtime
    from repro_torch.random import TorchDraws
    from repro_torch.serve import ContinuousBatchingEngine, EngineConfig, TraceConfig, make_trace
    from repro_torch.serve.static import serve_runtime

    slots = args.slots or args.batch
    ecfg = EngineConfig(slots=slots, page_size=args.page_size, prompt_len=args.prompt_len,
                        max_gen=args.gen, max_requests=max(args.requests, 1),
                        attn=args.attn, policy=args.policy)
    runtime = Runtime() if rules is None else serve_runtime(rules)
    engine = ContinuousBatchingEngine(model, params, ecfg, runtime=runtime, tap=tap)
    show = rules is None or rules.mesh.rank == 0
    if rules is not None:
        from repro_torch.dist.collectives import census_line

        stats = engine.decode_collectives()
        if show:
            print(census_line(stats), flush=True)
    trace = make_trace(
        TorchDraws(args.seed + 1, "cpu"),
        TraceConfig(n_requests=args.requests, rate_per_s=args.rate, slo_ms=args.slo_ms,
                    prompt_len=args.prompt_len, min_gen=max(args.gen // 2, 1),
                    max_gen=args.gen),
        cfg,
    )
    rep = engine.serve(trace)
    if not show:
        return rep
    pct = rep.percentiles
    print(f"arch={cfg.name} device={device} engine=continuous slots={slots} "
          f"attn={args.attn} attn_impl={cfg.attn_impl} requests={rep.n_requests} "
          f"completed={rep.completed} rejected={rep.rejected}")
    print(f"[serve] latency p50={pct['p50']:.0f}ms p95={pct['p95']:.0f}ms "
          f"p99={pct['p99']:.0f}ms slo_violations={rep.slo_violations} "
          f"goodput={rep.goodput_rps:.2f} req/s")
    print(f"[serve] tokens={rep.tokens_generated} decode_steps={rep.decode_steps} "
          f"cold_starts={rep.cold_starts} energy_per_token={rep.energy_per_token_j:.2e} J "
          f"throughput={rep.tokens_per_wall_s:.0f} tok/s(wall)")
    print("generated token ids (first request):", rep.tokens_for(0))
    return rep


if __name__ == "__main__":
    main()
