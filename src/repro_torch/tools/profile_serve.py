"""Where the serving path's admissions and decode steps spend their time
on the card.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_serve [--steps 10]
        [--arch ARCH] [--attn paged|dense] [--slots 8] [--prompt-len 128]

Builds the full-width ``--arch`` in bf16 (random weights from a seed;
every family with attention with ``attn_impl="flash"``), admits one
request into every slot through the engine's admission program (prefill
via K5; K6 for rwkv6; hymba's SSM branch and internvl2's 8 patch
embeddings beside it), and runs the batched decode program over the full
slot batch (``--attn paged`` through K7, ``dense`` over the gathered
cache; rwkv6: the plain one-token recurrence, ``--attn`` not read).
seamless-m4t-medium (ENCDEC), which the continuous engine does not
serve, runs the static engine's path instead: an admission is one
prefill of the ``--slots`` rows (``--prompt-len`` frames and tokens; K5
on the encoder, the decoder and the cross-attention), a decode step
``decode_step`` over them (K5 on the cross-attention):

  * three unprofiled passes of ``--steps`` decode steps: the host clock
    around each pass, ending in a synchronise;
  * one pass of ``--steps`` decode steps and one of ``--slots``
    admissions under ``torch.profiler``: device kernel time per step (per
    admission), the device's busy share (kernel time over the profiled
    wall time), kernel launches per step (per admission) and the kernels
    that take the most device time.

Prints one JSON object. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch


def profile_calls(fn, n: int, top: int) -> dict:
    """``fn(i)`` for i < n under ``torch.profiler``: the profiled wall ms
    per call, the device's kernel ms and busy share per call ("not
    measured" if the profiler saw no device time), the launches per call
    and the ``top`` kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    kernels: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            kernels.setdefault(e.name, []).append(e.device_time_total / 1e3)
    device_ms = sum(sum(v) for v in kernels.values()) / n
    ranked = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:top]
    measured = bool(kernels)
    return {
        "profiled_wall_ms": wall_ms,
        "device_kernel_ms": device_ms if measured else "not measured",
        "device_busy_share": device_ms / wall_ms if measured else "not measured",
        "kernel_launches": sum(len(v) for v in kernels.values()) / n,
        "top_kernels": [
            {"name": k[:90], "ms": sum(v) / n, "calls": len(v) / n} for k, v in ranked
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=["llama3.2-1b", "rwkv6-1.6b", "hymba-1.5b", "internvl2-2b",
                             "seamless-m4t-medium"])
    ap.add_argument("--attn", default="paged", choices=["paged", "dense"])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-gen", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--top", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: needs a CUDA device")

    from repro_torch.configs import get_config
    from repro_torch.models import Family, build_model

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    attends = cfg.family is not Family.SSM
    if attends:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model.init(gen)
    s = args.slots
    if cfg.family is Family.ENCDEC:
        admit_one, decode_one = _static_path(args, cfg, model, params, dev)
    else:
        admit_one, decode_one = _paged_path(args, cfg, model, params, gen, dev)
    for i in range(s):  # fill every slot (and warm up)
        admit_one(i)
    for i in range(3):
        decode_one(i)
    wall = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(args.steps):
            decode_one(i)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) / args.steps * 1e3)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "arch": cfg.name, "dtype": cfg.param_dtype,
        "attn": args.attn if attends and cfg.family is not Family.ENCDEC else None,
        "attn_impl": cfg.attn_impl if attends else None, "slots": s,
        "prompt_len": args.prompt_len,
        "decode_wall_ms_per_step_by_pass": wall,
        "decode_step": profile_calls(decode_one, args.steps, args.top),
        "admission": profile_calls(admit_one, s, args.top),
        "peak_bytes": torch.cuda.max_memory_allocated(),
    }))
    return 0


def _static_path(args, cfg, model, params, dev):
    """ENCDEC: an admission prefills every row; a decode step advances
    them one token (positions wrap inside the cache)."""
    from repro_torch.launch.serve import static_batch

    batch, cache_len = static_batch(cfg, args.slots, args.prompt_len, args.max_gen, 0, dev)
    state = {}

    @torch.no_grad()
    def admit_one(i):
        logits, state["cache"] = model.prefill(params, batch, cache_len=cache_len)
        state["tokens"] = torch.argmax(logits[:, -1], dim=-1)[:, None]

    @torch.no_grad()
    def decode_one(i):
        state["cache"]["pos"] = args.prompt_len + i % (args.max_gen - 1)
        logits, state["cache"] = model.decode_step(params, state["cache"], state["tokens"])
        state["tokens"] = torch.argmax(logits[:, -1], dim=-1)[:, None]

    return admit_one, decode_one


def _paged_path(args, cfg, model, params, gen, dev):
    """Every other family: the engine's admission and decode programs."""
    from repro_torch.models import Family
    from repro_torch.serve import paged

    s = args.slots
    plan = paged.PagePlan.build(cfg, args.prompt_len, args.max_gen, page_size=args.page_size)
    n_tab = plan.pages_per_slot
    pool = paged.init_pool(cfg, plan, s, s * n_tab, device=dev)
    tokens = torch.zeros((s, 1), dtype=torch.int64, device=dev)
    out_buf = torch.zeros((s + 1, args.max_gen), dtype=torch.int32, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (s, args.prompt_len), generator=gen,
                            device=dev)
    embeds = None
    if cfg.family is Family.VLM:
        embeds = torch.randn((s, plan.n_patches, cfg.d_model), generator=gen,
                             device=dev).to(getattr(torch, cfg.compute_dtype))
    table = torch.arange(1, s * n_tab + 1, dtype=torch.int32, device=dev).reshape(s, n_tab)
    admit = paged.make_admit_fn(model, plan)
    step = paged.make_decode_fn(model, plan, attn=args.attn)
    positions = torch.full((s,), plan.prompt_eff, dtype=torch.int64, device=dev)
    active = torch.ones((s,), dtype=torch.bool, device=dev)
    out_req = torch.full((s,), s, dtype=torch.int64, device=dev)
    out_idx = torch.zeros((s,), dtype=torch.int64, device=dev)
    state = {"pool": pool, "tokens": tokens, "out_buf": out_buf}

    def admit_one(i):
        slot = i % s
        extra = [] if embeds is None else [embeds[slot:slot + 1]]
        admit(params, state["pool"], state["tokens"], state["out_buf"],
              prompts[slot:slot + 1], *extra, table[slot, :plan.prompt_pages].long(), slot,
              slot)

    def decode_one(i):
        # positions stay inside the slot's span: the step index wraps
        pos = positions + (i % (args.max_gen - 1))
        state["pool"], state["tokens"], state["out_buf"] = step(
            params, state["pool"], state["tokens"], state["out_buf"], table, pos,
            active, out_req, out_idx)

    return admit_one, decode_one


if __name__ == "__main__":
    raise SystemExit(main())
