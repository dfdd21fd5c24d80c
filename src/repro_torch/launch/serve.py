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
K decode steps of either engine through ``repro_torch.obs``. The mesh
options of the JAX launcher (``--devices``, ``--multi-pod``,
``--reduced``) belong to the distributed path and raise until ROADMAP.md
queue 1, item 11(b) ports it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


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
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--reduced", action="store_true")
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
        raise NotImplementedError(
            "--devices, --multi-pod and --reduced drive the distributed mesh path, "
            "not ported yet: ROADMAP.md queue 1, item 11(b)")

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


def _run_static(args, cfg, model, params, device, tap):
    import torch

    batch, cache_len = static_batch(cfg, args.batch, args.prompt_len, args.gen,
                                    args.seed, device)
    out = torch.zeros((args.batch, args.gen), dtype=torch.int32, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, cache_len=cache_len)
        toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out[:, 0] = toks[:, 0].int()
        sync()
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(1, args.gen):
            logits, cache = model.decode_step(params, cache, toks)
            toks = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out[:, i] = toks[:, 0].int()
            if tap is not None:
                tap.host_log({"step": i, "batch": args.batch}, step=i)
        out = out.cpu()  # the one device -> host read
        t_decode = time.perf_counter() - t0
    print(f"arch={cfg.name} device={device} prefill={t_prefill * 1e3:.1f}ms "
          f"decode={t_decode / max(args.gen - 1, 1) * 1e3:.2f}ms/tok")
    print("generated token ids (first row):", out[0].tolist())
    return out


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


def _run_continuous(args, cfg, model, params, device, tap):
    from repro_torch.random import TorchDraws
    from repro_torch.serve import ContinuousBatchingEngine, EngineConfig, TraceConfig, make_trace

    slots = args.slots or args.batch
    ecfg = EngineConfig(slots=slots, page_size=args.page_size, prompt_len=args.prompt_len,
                        max_gen=args.gen, max_requests=max(args.requests, 1),
                        attn=args.attn, policy=args.policy)
    engine = ContinuousBatchingEngine(model, params, ecfg, tap=tap)
    trace = make_trace(
        TorchDraws(args.seed + 1, "cpu"),
        TraceConfig(n_requests=args.requests, rate_per_s=args.rate, slo_ms=args.slo_ms,
                    prompt_len=args.prompt_len, min_gen=max(args.gen // 2, 1),
                    max_gen=args.gen),
        cfg,
    )
    rep = engine.serve(trace)
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
