"""Serving under mesh rules on a world of ranks, against the single-process
engines (``python -m repro_torch.dist.selftest --mode serve``):

    python -m repro_torch.dist.selftest --mode serve --devices 2 --model-split 2,1 \\
        --engine static,continuous --attn paged --flash --device cpu --check --json
    python -m repro_torch.dist.selftest --mode serve --devices 2 --batch 8,1 \\
        --engine static --flash --device cpu --check --json

Spawns ``--devices`` ranks (``dist.world``, on the CUDA card unless
``--device cpu``) on ``plan_for(device_count=N)`` or, with
``--model-split T,S``, the ``MeshPlan`` of N / (T·S) clients by (tp T,
sp S). Every rank draws the whole parameter tree from ``--seed`` and
keeps its blocks (``Model.init(generator, rules)``), then serves, in
order, a static batch for each ``--batch`` (``serve.static``: by rows,
by prompt span or replicated, as ``ShardingRules.serve_layout`` splits
it) and, with ``continuous`` in ``--engine``, a seeded trace of
``--requests`` requests on ``--slots`` slots (``ContinuousBatchingEngine``
on the rank's heads). Per run a rank reports its decode census (the
collectives of one decode step, ``dist.collectives``), the kernel
launches (K5, K7; set to 0 just before the run and read just after), the
wall ms of the prefill or admission and of a decode step, the wall ms
its collectives took in the run (a timed ``CollectiveLog``: a device
synchronisation before and after each), its peak device bytes and its
tokens; rank 0 also the first decode step's logits of the run, whole
(of the static batch; of the continuous engine's live slots,
``serve(keep_logits=True)``). The continuous engine's wall ms per
admission and decode step come from a timing probe after the run:
``--slots`` admissions, then ``PROBE_STEPS`` decode steps of the full
slot batch.

With ``--check`` the launcher, after the ranks exit, runs the
single-process engines on the same weights and requests (one intra-op
thread on the CPU), reports their wall ms per prefill or admission and
decode step beside the ranks', and holds rank 0 against them:

  * every request completes and every token lies in the vocabulary;
  * the census equals :func:`expected_census` for the layout: under a
    model split an all-reduce after attention and after the MLP a layer,
    one for the vocabulary-parallel embedding and one all-gather for the
    pick, plus one all-gather a layer of q, k and v over ``head_dim``
    with sp > 1 (the ``qk_norm`` scales were made whole before serving);
    under the sequence split two all-reduces a layer (the
    softmax max, then the rescaled sums); batch-parallel and replicated,
    none;
  * float32 (``--scale tiny``): every token equal to the single-process
    engine's and the first-step logits within ``F32_LOGITS_RTOL`` of its
    max |logit|;
  * bf16: the first-step logits within ``LOGITS_RTOL`` of the max |logit|
    of the single-process run with its attention, prefill and decode, on
    float32 copies through the plain versions (no K5, no K7;
    :func:`float32_attention`), and under a model split rank 0's rms
    distance to the whole run in float32 (the plain attention too) within
    ``BF16_TP_FACTOR`` times the single-process bf16 run's (as the tensor-parallel round is
    held, ``dist.selftest``): the row-parallel partial sums are rounded
    to bf16 before they are reduced, so tokens may part where logits
    nearly tie; how many requests agree over all their tokens is
    reported, not gated.

Prints one JSON line with ``--json``; exits 0 when every check holds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import numpy as np

LOGITS_RTOL = 0.05  # bf16: of the float32-attention reference's max |logit|
F32_LOGITS_RTOL = 1e-4  # float32: of the single-process logits' max |logit|
PAGE = 16
PROBE_STEPS = 4  # decode steps timed in the continuous probe


def serve_config(spec: dict):
    from repro_torch.dist.selftest import model_config

    cfg = model_config(spec["arch"], spec["scale"], dtype=spec.get("dtype"),
                       layers=spec.get("layers"))
    return dataclasses.replace(cfg, attn_impl="flash") if spec["flash"] else cfg


def serve_plan(cfg, devices: int, model_split=None):
    from repro_torch.dist.selftest import selftest_plan

    return selftest_plan(cfg, devices, zero=None, fog_nodes=1, model_split=model_split)


def expected_census(cfg, tp, seq) -> dict:
    """The collectives of one decode step (static or paged), by kind, on a
    rank with tensor view ``tp`` and sequence view ``seq`` (see the module
    docstring)."""
    L = cfg.num_layers
    out: dict[str, int] = {}

    def add(kind, n):
        if n:
            out[kind] = out.get(kind, 0) + n

    if tp is not None:
        add("all-reduce", L * (bool(tp.attn_axes) + bool(tp.mlp_axes)) + bool(tp.vocab_axes))
        add("all-gather", L * bool(tp.hd_axes) + bool(tp.vocab_axes))
    if seq is not None:
        add("all-reduce", 2 * L)
    return out


def _counts() -> dict:
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention.paged_attention import paged_attention_cuda

    return {"flash_attention_fwd": flash_attention_cuda.launches,
            "paged_attention_fwd": paged_attention_cuda.launches}


def _zero_counts() -> None:
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention.paged_attention import paged_attention_cuda

    flash_attention_cuda.launches = paged_attention_cuda.launches = 0


def engine_config(cfg, spec: dict):
    from repro_torch.serve import EngineConfig

    return EngineConfig(slots=spec["slots"], page_size=PAGE, prompt_len=spec["prompt_len"],
                        max_gen=spec["gen"], max_requests=spec["requests"], attn=spec["attn"])


def serve_trace(cfg, spec: dict):
    from repro_torch.random import TorchDraws
    from repro_torch.serve import TraceConfig, make_trace

    return make_trace(TorchDraws(spec["seed"] + 1, "cpu"), TraceConfig(
        n_requests=spec["requests"], rate_per_s=20.0, prompt_len=spec["prompt_len"],
        min_gen=max(spec["gen"] // 2, 1), max_gen=spec["gen"]), cfg)


def paged_timing(model, params, ecfg, prompts, runtime, *, attn: str) -> dict:
    """The wall ms of the continuous engine's programs: one admission of
    each of ``prompts`` (slots, prompt_len) into its own slot, then
    ``PROBE_STEPS`` decode steps of the full slot batch (``attn`` mode)."""
    import torch

    from repro_torch.serve import paged

    cfg = model.cfg
    dev = prompts.device
    slots = prompts.shape[0]
    plan = paged.PagePlan.build(cfg, ecfg.prompt_len, ecfg.max_gen, page_size=ecfg.page_size)
    n_tab = plan.pages_per_slot
    pool = paged.init_pool(cfg, plan, slots, slots * n_tab, device=dev, runtime=runtime)
    tokens = torch.zeros((slots, 1), dtype=torch.int64, device=dev)
    out_buf = torch.zeros((slots + 1, plan.max_gen), dtype=torch.int32, device=dev)
    table = torch.arange(1, slots * n_tab + 1, dtype=torch.int32,
                         device=dev).reshape(slots, -1)
    admit = paged.make_admit_fn(model, plan, runtime)
    step = paged.make_decode_fn(model, plan, runtime, attn)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for s in range(slots):
        admit(params, pool, tokens, out_buf, prompts[s:s + 1],
              table[s, :plan.prompt_pages].long(), s, s)
    sync()
    admit_ms = (time.perf_counter() - t0) / slots * 1e3
    positions = torch.full((slots,), plan.prompt_eff, dtype=torch.int64, device=dev)
    active = torch.ones((slots,), dtype=torch.bool, device=dev)
    out_req = torch.full((slots,), slots, dtype=torch.int64, device=dev)
    out_idx = torch.zeros((slots,), dtype=torch.int64, device=dev)
    sync()
    t0 = time.perf_counter()
    for i in range(PROBE_STEPS):
        pool, tokens, out_buf = step(params, pool, tokens, out_buf, table, positions + i,
                                     active, out_req, out_idx)
    sync()
    return dict(admit_ms=admit_ms, decode_ms=(time.perf_counter() - t0) / PROBE_STEPS * 1e3)


def _whole_logits(x, runtime, layout, mesh):
    """A rank's (rows, V_local) logits -> the whole (B, V) on every rank."""
    import torch

    from repro_torch.dist.tensor_parallel import _all_gather

    tp = runtime.tensor
    if tp is not None and tp.vocab_axes:
        x = tp.gather(x.contiguous(), tp.vocab_axes)
    if layout is not None and layout.kind == "batch" and layout.ways > 1:
        whole = torch.empty((layout.ways * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device)
        _all_gather(whole, x.contiguous(), mesh.group(layout.axes))
        x = whole
    return x


def runs_of(spec: dict) -> list[tuple[str, int]]:
    """(engine, batch or slots) of every run, in order."""
    out = [("static", b) for b in spec["batches"]] if "static" in spec["engines"] else []
    if "continuous" in spec["engines"]:
        out.append(("continuous", spec["slots"]))
    return out


def rank_serve(ctx, spec: dict) -> list[dict]:
    """One rank of the serving selftest: one record a run (see the module
    docstring)."""
    import torch

    from repro_torch.dist import make_rules
    from repro_torch.dist.collectives import CollectiveLog
    from repro_torch.launch.serve import static_batch
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousBatchingEngine
    from repro_torch.serve.static import decode_census, serve_runtime, serve_static

    cfg = serve_config(spec)
    plan = serve_plan(cfg, ctx.world_size, spec.get("model_split"))
    rules = make_rules(None, cfg, plan=plan, backend=ctx.backend, device=ctx.device)
    model = build_model(cfg)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(spec["seed"])
    params = model.init(gen, rules)
    cuda = ctx.device.type == "cuda"
    root = ctx.rank == 0
    records = []
    for engine, n in runs_of(spec):
        rec = dict(engine=engine, n=n)
        if engine == "static":
            batch, cache_len = static_batch(cfg, n, spec["prompt_len"], spec["gen"],
                                            spec["seed"], ctx.device)
            runtime = serve_runtime(rules, n, spec["prompt_len"])
            layout = rules.serve_layout(n, spec["prompt_len"])
            census = decode_census(model, params, layout.rows[1] - layout.rows[0], cache_len,
                                   spec["prompt_len"], runtime, ctx.device)
            rec["layout"] = dict(kind=layout.kind, axes=list(layout.axes), rows=layout.rows)
        else:
            ecfg = engine_config(cfg, dict(spec, slots=n))
            runtime, layout = serve_runtime(rules), None
            eng = ContinuousBatchingEngine(model, params, ecfg, runtime=runtime)
            census = eng.decode_collectives()
            trace = serve_trace(cfg, spec)
            rec["layout"] = dict(kind="replicated", axes=[], rows=(0, n))
        rec["census"] = dict(count_by_kind=census.count_by_kind,
                             total_bytes=census.total_bytes,
                             expected=expected_census(cfg, runtime.tensor, runtime.sequence))
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        with CollectiveLog(timed=True) as log:
            if engine == "static":
                res = serve_static(model, params, batch, cache_len, spec["gen"], rules=rules,
                                   keep_logits=True)
            else:
                rep = eng.serve(trace, keep_logits=True)
        if cuda:
            torch.cuda.synchronize()
        rec.update(wall_ms=(time.perf_counter() - t0) * 1e3, launches=_counts(),
                   peak_bytes=torch.cuda.max_memory_allocated() if cuda else None,
                   collectives=log.stats().count_by_kind,
                   collective_ms=sum(op.ms for op in log.ops))
        if engine == "static":
            first = res.first_logits
            rec.update(tokens=res.tokens, prefill_ms=res.prefill_ms, decode_ms=res.decode_ms,
                       prefills=1, decode_steps=spec["gen"] - 1)
        else:
            prompts = torch.from_numpy(trace.prompts[:n]).to(ctx.device)
            probe = paged_timing(model, eng.params, ecfg, prompts, runtime, attn=spec["attn"])
            first = rep.first_logits
            rec.update(tokens=rep.tokens, gen_len=rep.gen_len, completed=rep.completed,
                       rejected=rep.rejected, prefills=rep.prefills,
                       decode_steps=rep.decode_steps, admit_ms=probe["admit_ms"],
                       decode_ms=probe["decode_ms"])
        whole = _whole_logits(first, runtime, layout, rules.mesh)
        rec["first_logits"] = whole.float().cpu().numpy() if root else None
        del first, whole
        records.append(rec)
    return records


@contextlib.contextmanager
def float32_attention():
    """The single-process engines' attention, prefill and decode, on float32
    copies through the plain versions (``layers.attention_xla`` and
    ``attention_decode``; no K5, no K7), rounded once to the model dtype.
    The continuous engine takes it in its dense mode."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as tf
    from repro_torch.serve import paged

    def prefill(impl, q, k, v, q_pos, k_pos, window, **kw):
        return layers.attention_xla(q.float(), k.float(), v.float(), q_pos, k_pos, window,
                                    bidirectional=kw.get("bidirectional", False)).to(q.dtype)

    def decode(q, k, v, positions, window):
        return layers.attention_decode(q.float(), k.float(), v.float(), positions,
                                       window).to(q.dtype)

    saved = tf.select_attention, tf.attention_decode, paged.attention_decode
    tf.select_attention, tf.attention_decode, paged.attention_decode = prefill, decode, decode
    try:
        yield
    finally:
        tf.select_attention, tf.attention_decode, paged.attention_decode = saved


def _float32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def _single(model, params, spec, engine, n, dev, *, plain_f32=False, logits_only=False):
    """The single-process run of one (engine, n): (tokens and timing record,
    None with ``logits_only``; first decode step's logits (rows, V) float32
    numpy). ``plain_f32``: under :func:`float32_attention`, the continuous
    engine in its dense mode. ``logits_only`` stops after that step."""
    import torch

    from repro_torch.launch.serve import static_batch
    from repro_torch.models import Runtime
    from repro_torch.serve import ContinuousBatchingEngine
    from repro_torch.serve.static import serve_static

    cfg = model.cfg
    with float32_attention() if plain_f32 else contextlib.nullcontext():
        if engine == "static":
            batch, cache_len = static_batch(cfg, n, spec["prompt_len"], spec["gen"],
                                            spec["seed"], dev)
            res = serve_static(model, params, batch, cache_len,
                               2 if logits_only else spec["gen"], keep_logits=True)
            rec = None if logits_only else dict(tokens=res.tokens, prefill_ms=res.prefill_ms,
                                                decode_ms=res.decode_ms)
            return rec, res.first_logits.float().cpu().numpy()
        ecfg = engine_config(cfg, dict(spec, slots=n, attn="dense" if plain_f32
                                       else spec["attn"]))
        trace = serve_trace(cfg, spec)
        rep = ContinuousBatchingEngine(model, params, ecfg).serve(
            trace, max_steps=1 if logits_only else 0, keep_logits=True)
        rec = None
        if not logits_only:
            rec = dict(tokens=rep.tokens, gen_len=rep.gen_len)
            probe = paged_timing(model, params, ecfg,
                                 torch.from_numpy(trace.prompts[:n]).to(dev), Runtime(),
                                 attn=spec["attn"])
            rec.update(prefill_ms=probe["admit_ms"], decode_ms=probe["decode_ms"])
        return rec, rep.first_logits.float().cpu().numpy()


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


def reference(spec: dict, rank0: list[dict], device) -> list[dict]:
    """The single-process engines on the same weights and requests; rank
    0's runs held against them (see the module docstring)."""
    import torch

    from repro_torch import tree
    from repro_torch.dist.selftest import BF16_TP_FACTOR
    from repro_torch.models import build_model

    cfg = serve_config(spec)
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(spec["seed"])
    params = model.init(gen)
    tensor = spec.get("model_split") is not None and math.prod(spec["model_split"]) > 1
    bf16 = cfg.param_dtype == "bfloat16"
    v = cfg.vocab_size
    out = []
    for rec in rank0:
        engine, n = rec["engine"], rec["n"]
        ref, logits = _single(model, params, spec, engine, n, device)
        mine = rec["first_logits"][:, :v]
        logits = logits[:, :v]
        held = dict(engine=engine, n=n)
        toks = rec["tokens"]
        if engine == "static":
            held["completed"] = bool(toks.shape == (n, spec["gen"]))
            agree = int(sum(np.array_equal(a, b) for a, b in zip(toks, ref["tokens"])))
        else:
            lens = [int(x) for x in rec["gen_len"]]
            held["completed"] = rec["completed"] == spec["requests"] and rec["rejected"] == 0
            agree = int(sum(np.array_equal(toks[r, :g], ref["tokens"][r, :g])
                            for r, g in enumerate(lens)))
            toks = np.concatenate([toks[r, :g] for r, g in enumerate(lens)])
        held["in_vocab"] = bool(((toks >= 0) & (toks < v)).all())
        held["requests_agreeing"] = agree
        held["requests"] = n if engine == "static" else spec["requests"]
        held["census_ok"] = rec["census"]["count_by_kind"] == rec["census"]["expected"]
        held["single_prefill_ms"] = ref["prefill_ms"]
        held["single_decode_ms"] = ref["decode_ms"]
        if not bf16:
            scale = float(np.abs(logits).max())
            err = float(np.abs(mine - logits).max())
            held.update(logits_err=err, logits_scale=scale,
                        logits_ok=err <= F32_LOGITS_RTOL * scale,
                        tokens_ok=agree == held["requests"])
        else:
            _, f32a = _single(model, params, spec, engine, n, device, plain_f32=True,
                              logits_only=True)
            f32a = f32a[:, :v]
            scale = float(np.abs(f32a).max())
            err = float(np.abs(mine - f32a).max())
            held.update(logits_err=err, logits_scale=scale,
                        logits_ok=err <= LOGITS_RTOL * scale, tokens_ok=True)
            if tensor:
                model32 = build_model(_float32(cfg))
                params32 = tree.map(lambda x: x.float(), params)
                _, t32 = _single(model32, params32, spec, engine, n, device, plain_f32=True,
                                 logits_only=True)
                del params32
                t32 = t32[:, :v]
                d_mine, d_plain = _rms(mine - t32), _rms(logits - t32)
                tol = BF16_TP_FACTOR * d_plain + 2.0 ** -16 * _rms(t32)
                held.update(rms_to_f32=d_mine, single_rms_to_f32=d_plain,
                            rms_ratio=d_mine / d_plain if d_plain else 0.0,
                            truth_ok=d_mine <= tol)
        held["ok"] = bool(held["completed"] and held["in_vocab"] and held["census_ok"]
                          and held["logits_ok"] and held["tokens_ok"]
                          and held.get("truth_ok", True))
        out.append(held)
    return out


def run_serve(arch: str = "llama3.2-1b", devices: int = 2, *, engines=("static",),
              batches=(4,), slots: int = 4, requests: int = 8, prompt_len: int = 16,
              gen: int = 8, attn: str = "dense", flash: bool = False, model_split=None,
              check: bool = True, device=None, backend: str = "gloo", scale: str = "tiny",
              dtype: str | None = None, layers: int | None = None, seed: int = 0) -> dict:
    """The serving selftest (see the module docstring) on ``device``: None
    the CUDA card, the CPU only when asked for by name."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.dist.world import spawn
    from repro_torch.models import build_model

    dev = resolve_device(device)
    spec = dict(arch=arch, scale=scale, dtype=dtype, layers=layers, flash=flash,
                engines=list(engines), batches=list(batches), slots=slots,
                requests=requests, prompt_len=prompt_len, gen=gen, attn=attn, seed=seed,
                model_split=None if model_split is None else tuple(model_split))
    cfg = serve_config(spec)
    plan = serve_plan(cfg, devices, spec["model_split"])
    t0 = time.perf_counter()
    per_rank = spawn(rank_serve, devices, spec, backend=backend, device=dev, timeout=3600.0)
    world_s = time.perf_counter() - t0
    rank0 = per_rank[0]
    runs = []
    for i, rec in enumerate(rank0):
        runs.append(dict(
            engine=rec["engine"], n=rec["n"], layout=rec["layout"], census=rec["census"],
            census_bytes=rec["census"]["total_bytes"],
            launches=[r[i]["launches"] for r in per_rank],
            peak_bytes=[r[i]["peak_bytes"] for r in per_rank],
            wall_ms=[r[i]["wall_ms"] for r in per_rank],
            prefill_ms=[r[i].get("prefill_ms", r[i].get("admit_ms")) for r in per_rank],
            decode_ms=[r[i]["decode_ms"] for r in per_rank],
            prefills=rec["prefills"], decode_steps=rec["decode_steps"],
            same_on_ranks=all(np.array_equal(r[i]["tokens"], rec["tokens"]) for r in per_rank),
            collectives=rec["collectives"],
            collective_ms=[r[i]["collective_ms"] for r in per_rank],
        ))
    result = dict(arch=arch, scale=scale, devices=devices, device=str(dev), backend=backend,
                  layers=cfg.num_layers, dtype=cfg.param_dtype, attn_impl=cfg.attn_impl,
                  attn=attn, param_count=build_model(cfg).param_count(),
                  plan=dict(shape=plan.shape), world_s=world_s, runs=runs)
    ok = all(r["same_on_ranks"] and r["census"]["count_by_kind"] == r["census"]["expected"]
             for r in runs)
    if check:
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        threads = torch.get_num_threads()
        if dev.type == "cpu":
            torch.set_num_threads(1)
        t0 = time.perf_counter()
        try:
            result["check"] = reference(spec, rank0, dev)
        finally:
            torch.set_num_threads(threads)
        result["reference_s"] = time.perf_counter() - t0
        ok = ok and all(h["ok"] for h in result["check"])
    result["ok"] = bool(ok)
    return result
