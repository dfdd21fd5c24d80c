#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises and exits non-zero):

  1. device   — the card's name, device count, nvidia-smi name and power limit;
  2. build    — nvcc builds the delta-pipeline kernels from csrc/ (seconds,
                and the -Xptxas -v register / shared-memory report);
  3. kernels  — K2 (delta_sq_norms) and K3 (delta_pipeline_apply) held
                against their plain PyTorch versions on the card, at the
                slice's shape (C=64, P=112,766 in the MLP's six leaves) and a
                small ragged shape, over six gate sets; K4
                (delta_pipeline_partial) likewise at (C_local, P) = (16,
                112,766), (64, 112,766) and a ragged (16, 1,000), gates none /
                clip (with K2) / int8 / top-k; then K2, K3 and K4 timed at the
                main path's shapes beside the plain version, the byte bound
                and one PyTorch library call;
  4. slices   — the port's main paths through FedFogSimulator(...,
                device="cuda").run_scanned(), launch counts set to 0 just
                before each run and read just after:
                  dense: SimulatorConfig(rounds=20, use_pallas_agg=True); K3
                  once per round, every metric finite, round-0 cold starts
                  equal to the selected count, final accuracy >= 0.85; then 3
                  rounds each with the median and trimmed-mean aggregators;
                  population and fog: SimulatorConfig(population=1_000_000,
                  num_clients=64, fog_nodes=4, use_pallas_agg=True,
                  rounds=20); K4 launched 4 times per round and K2 / K3 never,
                  every metric finite, at most top-k = 24 selected per round,
                  final accuracy >= POP_FOG_MIN_ACCURACY; its init seconds at
                  M = 10^6, ms/round and peak bytes printed; then 3 rounds at
                  population 10^6 with one fog (K3 three times) and 3 dense
                  rounds with four fogs (K4 twelve times);
  5. result   — the kernels' JSON line, nvidia-smi's line and, last,
                {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package. Without a CUDA device, or
run from a directory without ``src/repro_torch``, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM data sheet, at the 700 W power limit: HBM rate, and float32
# outside the tensor cores (both kernels do float32 FMAs on CUDA cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Six leaves of the 784-128-64-62 MLP in fused order ([b, w] per layer).
SLICE_SEGS = (128, 784 * 128, 64, 128 * 64, 62, 64 * 62)
RAGGED_SEGS = (41, 8, 64, 17)
K4_RAGGED_SEGS = (300, 37, 600, 63)  # P = 1,000
# Accuracy floor of the population-and-fog run: the JAX package's own
# final accuracy at this configuration on the CPU, less 0.05, once that
# run (a million-client registry on a CPU) has been made; until then 0.80.
POP_FOG_MIN_ACCURACY = 0.80
POP_FOG = dict(population=1_000_000, num_clients=64, fog_nodes=4)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, n_iter: int, n_warm: int = 5) -> float:
    """Mean device milliseconds per call from CUDA events around ``n_iter``
    calls. A spin kernel queued first keeps the device busy while the host
    enqueues the calls, so host overhead per call does not leave the device
    idle inside the timed span (without it a 20 us kernel behind ~20 us of
    Python per call reads as the host's rate)."""
    import torch

    for i in range(n_warm):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)  # ~0.2 s of device cycles, before `start`
    start.record()
    for i in range(n_iter):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def make_inputs(torch, c, segs, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    p = sum(segs)
    f = dict(generator=g, device=device)
    return dict(
        upd=torch.randn((c, p), **f) * 0.05,
        base=torch.randn((p,), **f),
        mask=torch.rand((c,), **f) < 0.7,
        weights=torch.rand((c,), **f) * 300 + 10,
        noise=0.01 * torch.randn((p,), **f),
        mu=torch.randn((p,), **f) * 0.01,
        staleness=torch.arange(c, device=device, dtype=torch.float32) % 4,
    )


# (name, kwargs builder). Each output is held to ATOL + RTOL·|r − i|, where
# r is the plain version's output and i the input it updates (base or μ):
# the tolerance scales with the kernel's own step lr·agg (~5e-3 here), not
# with the ~1-sized base it is added to. ATOL covers one rounding of the
# output at |base| < 8 (one ulp there is 4.8e-7).
GATES = [
    ("fedavg", lambda fx, segs: {}),
    ("fedavg+dp", lambda fx, segs: dict(dp_noise=fx["noise"])),
    ("median", lambda fx, segs: dict(aggregator="median")),
    ("trimmed", lambda fx, segs: dict(aggregator="trimmed", trim_fraction=0.1)),
    ("fedavg+clip+int8+staleness+fedavgm", lambda fx, segs: dict(
        clip_norm=1.5, compression="int8", seg_sizes=segs,
        staleness=fx["staleness"], staleness_exponent=0.5, momentum=fx["mu"],
        server_optimizer="fedavgm")),
    ("fedavg+clip+topk+fedadam", lambda fx, segs: dict(
        clip_norm=1.5, compression="topk", topk_fraction=0.1, seg_sizes=segs,
        momentum=fx["mu"], server_optimizer="fedadam")),
]
ATOL, RTOL = 1e-6, 1e-5


def check_partial(torch, dp, dev):
    """K4 against its plain version over the gates, at a fog's block of the
    main path (16 clients), the whole cohort (64) and a ragged (16, 1,000).
    K4's sum is unnormalized (weights mask·|D| of ~10²); the cloud divides
    it by Σdm, after which it is held to K3's tolerance with the partial as
    the step: |o − r| ≤ (ATOL + RTOL·|r|/Σdm)·Σdm. Returns the max abs error
    of the unnormalized outputs."""
    worst = 0.0
    for shape_name, c, segs in (("fog", 16, SLICE_SEGS), ("cohort", 64, SLICE_SEGS),
                                ("ragged", 16, K4_RAGGED_SEGS)):
        fx = make_inputs(torch, c, segs, 4321, dev)
        dm = fx["mask"].float() * fx["weights"]
        scale = float(dm.sum())
        for name, kw in (
            ("none", {}),
            ("clip", dict(clip_norm=1.5)),
            ("int8", dict(compression="int8", seg_sizes=segs)),
            ("topk", dict(compression="topk", topk_fraction=0.1, seg_sizes=segs)),
            ("clip+int8", dict(clip_norm=1.5, compression="int8", seg_sizes=segs)),
        ):
            out = dp.delta_pipeline_partial(fx["upd"], dm, **kw)
            ref = dp.delta_pipeline_partial_ref(fx["upd"], dm, **kw)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"partial {name}: non-finite output")
            err = float((out - ref).abs().max())
            bad = (out - ref).abs() > (ATOL + RTOL * ref.abs() / scale) * scale
            say("kernels", kernel="delta_pipeline_partial", shape=shape_name,
                gates=name, C_local=c, P=sum(segs), max_abs_err=err,
                sum_dm=scale, atol=f"{ATOL} of sum_dm", rtol=f"{RTOL} of |partial|")
            check(not bool(bad.any()),
                  f"delta_pipeline_partial {name} {shape_name}: max_abs_err {err}")
            worst = max(worst, err)
    return worst


def phase_kernels(torch, dp):
    """Phase 3: kernel vs plain version, then timing. Returns per-kernel
    dicts for the JSON line (launches filled in by the slice phase)."""
    dev = torch.device("cuda")
    errs = {"delta_sq_norms": 0.0, "delta_pipeline_apply": 0.0}
    for shape_name, c, segs in (("slice", 64, SLICE_SEGS), ("ragged", 6, RAGGED_SEGS)):
        fx = make_inputs(torch, c, segs, 1234, dev)
        k2 = dp.delta_sq_norms(fx["upd"])
        r2 = dp.delta_sq_norms_ref(fx["upd"])
        torch.cuda.synchronize()
        e2 = float((k2 - r2).abs().max())
        tol2 = 1e-5 * float(r2.abs().max())
        say("kernels", kernel="delta_sq_norms", shape=shape_name, C=c, P=sum(segs),
            max_abs_err=e2, tol=tol2)
        check(e2 <= tol2, f"delta_sq_norms {shape_name}: {e2} > {tol2}")
        errs["delta_sq_norms"] = max(errs["delta_sq_norms"], e2)
        for name, build in GATES:
            kw = build(fx, segs)
            args = (fx["upd"], fx["base"], fx["mask"], fx["weights"])
            out = dp.delta_pipeline_apply(*args, lr=0.7, **kw)
            ref = dp.delta_pipeline_ref(*args, lr=0.7, **kw)
            torch.cuda.synchronize()
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            ins = (fx["base"], fx["mu"])
            err = step = 0.0
            for o, r, i in zip(outs, refs, ins):
                check(bool(torch.isfinite(o).all()), f"{name}: non-finite output")
                err = max(err, float((o - r).abs().max()))
                step = max(step, float((r - i).abs().max()))
                bad = (o - r).abs() > ATOL + RTOL * (r - i).abs()
                check(not bool(bad.any()),
                      f"delta_pipeline_apply {name} {shape_name}: max_abs_err {err}")
            say("kernels", kernel="delta_pipeline_apply", shape=shape_name, gates=name,
                C=c, P=sum(segs), max_abs_err=err, max_abs_step=step, atol=ATOL,
                rtol=f"{RTOL} of |step|")
            errs["delta_pipeline_apply"] = max(errs["delta_pipeline_apply"], err)
        # No client selected: the reference's index arithmetic gives a +inf
        # median and the unchanged base for the trimmed mean; both must
        # match it exactly (inf included).
        none = torch.zeros_like(fx["mask"])
        for agg in ("median", "trimmed"):
            args = (fx["upd"], fx["base"], none, fx["weights"])
            out = dp.delta_pipeline_apply(*args, lr=0.7, aggregator=agg)
            ref = dp.delta_pipeline_ref(*args, lr=0.7, aggregator=agg)
            check(torch.equal(out, ref), f"{agg} with no client selected {shape_name}")
            say("kernels", kernel="delta_pipeline_apply", shape=shape_name,
                gates=f"{agg}, no client selected", equal=True,
                all_inf=bool(torch.isinf(out).all()))

    errs["delta_pipeline_partial"] = check_partial(torch, dp, dev)

    # ---- timing at the slice's shape (the main path's gates: plain Eq. 6)
    from repro_torch.kernels.delta_pipeline import delta_pipeline as cu

    c, segs = 64, SLICE_SEGS
    p = sum(segs)
    # Four copies of the 28.9 MB buffer (115 MB > the 50 MB L2), used in
    # turn, so each call reads its deltas from device memory as the round
    # does after local training has streamed other data through the cache.
    bufs = [make_inputs(torch, c, segs, 7 + i, dev) for i in range(4)]
    rows = [
        cu.pipeline_rows(b["upd"], b["mask"], b["weights"], None, 0.0, 0.1,
                         clip_norm=0.0, compression="none", topk_fraction=0.05,
                         seg_sizes=None, aggregator="fedavg")
        for b in bufs
    ]
    out = torch.empty((p,), device=dev)
    lr = 1.0

    def k3(i):
        b, (wn, cnt, pre, seg, tab) = bufs[i % 4], rows[i % 4]
        cu.launch_pipeline(b["upd"], b["base"], wn, cnt, pre, seg, tab, None, None,
                           out, None, lr=lr, server_momentum=0.9,
                           compression="none", aggregator="fedavg",
                           server_optimizer="fedavg")

    def k3_wrapper(i):
        b = bufs[i % 4]
        dp.delta_pipeline_apply(b["upd"], b["base"], b["mask"], b["weights"], lr=lr)

    def k3_plain(i):
        b = bufs[i % 4]
        dp.delta_pipeline_ref(b["upd"], b["base"], b["mask"], b["weights"], lr=lr)

    def k3_lib(i):
        b, wn = bufs[i % 4], rows[i % 4][0]
        torch.addmv(b["base"], b["upd"].t(), wn, alpha=lr, out=out)

    def k2(i):
        dp.delta_sq_norms(bufs[i % 4]["upd"])

    def k2_plain(i):
        dp.delta_sq_norms_ref(bufs[i % 4]["upd"])

    def k2_lib(i):
        u = bufs[i % 4]["upd"]
        torch.linalg.vecdot(u, u)

    # K4 on the population-and-fog path: one fog's 16-row block of the
    # (64, P) buffer, its unnormalized weights mask·|D|; the sixteen blocks
    # of the four buffers are used in turn (115 MB > L2).
    cl = c // 4
    blocks = [(b["upd"][f * cl:(f + 1) * cl],
               (b["mask"].float() * b["weights"])[f * cl:(f + 1) * cl].contiguous())
              for b in bufs for f in range(4)]
    out4 = torch.empty((p,), device=dev)

    def k4(i):
        x, dm = blocks[i % 16]
        cu.launch_partial(x, dm, None, None, None, out4, compression="none")

    def k4_plain(i):
        x, dm = blocks[i % 16]
        dp.delta_pipeline_partial_ref(x, dm)

    def k4_lib(i):
        x, dm = blocks[i % 16]
        torch.mv(x.t(), dm, out=out4)

    t = {
        "k4": cuda_ms(k4, 400), "k4_plain": cuda_ms(k4_plain, 20),
        "k4_lib": cuda_ms(k4_lib, 400),
        "k3": cuda_ms(k3, 200), "k3_wrapper": cuda_ms(k3_wrapper, 200),
        "k3_plain": cuda_ms(k3_plain, 20), "k3_lib": cuda_ms(k3_lib, 200),
        "k2": cuda_ms(k2, 200), "k2_plain": cuda_ms(k2_plain, 100),
        "k2_lib": cuda_ms(k2_lib, 200),
    }
    k3_bytes = 4 * (c * p + p + p + c)  # deltas, base, out, weights row
    k2_bytes = 4 * (c * p + c)  # deltas, norms
    # One FMA (2 operations) per delta element in each; K3 adds lr·agg + base.
    by3 = (k3_bytes / HBM_BYTES_PER_S, 2 * (c * p + p) / FP32_FLOP_PER_S)
    by2 = (k2_bytes / HBM_BYTES_PER_S, 2 * c * p / FP32_FLOP_PER_S)
    k4_bytes = 4 * (cl * p + cl + p)  # one fog's deltas, its weights, out
    by4 = (k4_bytes / HBM_BYTES_PER_S, 2 * cl * p / FP32_FLOP_PER_S)
    bound3, bound2, bound4 = max(by3) * 1e3, max(by2) * 1e3, max(by4) * 1e3
    bound_by3 = "bytes" if by3[0] >= by3[1] else "operations"
    bound_by2 = "bytes" if by2[0] >= by2[1] else "operations"
    bound_by4 = "bytes" if by4[0] >= by4[1] else "operations"
    say("timing", kernel="delta_pipeline_apply", C=c, P=p, ms=t["k3"],
        wrapper_ms=t["k3_wrapper"], plain_ms=t["k3_plain"], library_ms=t["k3_lib"],
        library="torch.addmv", bound_ms=bound3, bytes=k3_bytes,
        share_of_bound=bound3 / t["k3"])
    say("timing", kernel="delta_sq_norms", C=c, P=p, ms=t["k2"],
        plain_ms=t["k2_plain"], library_ms=t["k2_lib"],
        library="torch.linalg.vecdot", bound_ms=bound2, bytes=k2_bytes,
        share_of_bound=bound2 / t["k2"])
    say("timing", kernel="delta_pipeline_partial", C_local=cl, P=p, ms=t["k4"],
        plain_ms=t["k4_plain"], library_ms=t["k4_lib"], library="torch.mv",
        bound_ms=bound4, bytes=k4_bytes, share_of_bound=bound4 / t["k4"])
    src = "src/repro_torch/kernels/delta_pipeline/csrc/delta_pipeline.cu"
    pallas = "src/repro/kernels/delta_pipeline/delta_pipeline.py"
    return [
        {"name": "delta_sq_norms", "route": "cuda", "source": src,
         "replaces": f"{pallas}:80", "launches": None, "on_main_path": False,
         "max_abs_err": errs["delta_sq_norms"], "ms": t["k2"],
         "plain_ms": t["k2_plain"], "bound_ms": bound2, "bound_by": bound_by2,
         "library_ms": t["k2_lib"]},
        {"name": "delta_pipeline_apply", "route": "cuda", "source": src,
         "replaces": f"{pallas}:436", "launches": None, "on_main_path": True,
         "max_abs_err": errs["delta_pipeline_apply"], "ms": t["k3"],
         "plain_ms": t["k3_plain"], "bound_ms": bound3, "bound_by": bound_by3,
         "library_ms": t["k3_lib"]},
        {"name": "delta_pipeline_partial", "route": "cuda", "source": src,
         "replaces": f"{pallas}:536", "launches": None, "on_main_path": True,
         "max_abs_err": errs["delta_pipeline_partial"], "ms": t["k4"],
         "plain_ms": t["k4_plain"], "bound_ms": bound4, "bound_by": bound_by4,
         "library_ms": t["k4_lib"]},
    ]


def run_slice(torch, cu, sim_mod, rounds, **overrides):
    """Drive a main path of the port: build the simulator, set the launch
    counts to 0, run ``run_scanned()``, read the counts. Returns (history,
    {kernel: launches}, init seconds, run seconds, peak bytes)."""
    cfg = sim_mod.SimulatorConfig(rounds=rounds, use_pallas_agg=True, **overrides)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = sim_mod.FedFogSimulator(cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cu.delta_sq_norms_cuda.launches = 0
    cu.launch_pipeline.launches = 0
    cu.launch_partial.launches = 0
    t0 = time.perf_counter()
    hist = sim.run_scanned()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"delta_sq_norms": cu.delta_sq_norms_cuda.launches,
                "delta_pipeline_apply": cu.launch_pipeline.launches,
                "delta_pipeline_partial": cu.launch_partial.launches}
    for k, v in hist.items():
        vals = v if isinstance(v, list) else [v]
        check(all(math.isfinite(x) for x in vals), f"metric {k} not finite")
    return hist, launches, init_s, seconds, torch.cuda.max_memory_allocated()


def expect_launches(launches, **want):
    for name, n in want.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times, not {n}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    say("device", name=repr(kind), count=count, torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=repr(smi))
    limit_w = float(smi.rsplit(",", 1)[1].strip().split()[0])
    if limit_w < 700.0:
        say("device", note=f"power limit {limit_w} W is below the 700 W at which "
            "the 3.35 TB/s of the byte bounds is specified")

    # 2. build
    from repro_torch.kernels import delta_pipeline as dp
    from repro_torch.kernels.delta_pipeline import delta_pipeline as cu

    kl = cu.library()
    ptxas = [ln.strip() for ln in kl.log_path.read_text().splitlines()
             if "registers" in ln or "bytes stack" in ln or "Compiling entry" in ln]
    say("build", library=kl.path.name, seconds=kl.build_seconds)
    for ln in ptxas:
        print(f"[build] ptxas {ln}", flush=True)

    # 3. kernels against their plain versions, then timing
    kernels = phase_kernels(torch, dp)

    # 4. the slices: the port's main paths
    from repro_torch.fl import simulator as sim_mod

    run_slice(torch, cu, sim_mod, 1)  # warm-up: cuBLAS handles, allocator
    hist, launches, _, seconds, peak = run_slice(torch, cu, sim_mod, 20)
    expect_launches(launches, delta_pipeline_apply=20, delta_pipeline_partial=0)
    kernels[0]["launches"] = launches["delta_sq_norms"]
    kernels[1]["launches"] = launches["delta_pipeline_apply"]
    acc = hist["accuracy"]
    say("slice", rounds=20, k3_launches=launches["delta_pipeline_apply"],
        k2_launches=launches["delta_sq_norms"], ms_per_round=seconds / 20 * 1e3,
        peak_bytes=peak, accuracy=[round(a, 4) for a in acc],
        num_selected=hist["num_selected"][0], cold_starts_round0=hist["cold_starts"][0])
    check(hist["cold_starts"][0] == hist["num_selected"][0],
          "round-0 cold starts != selected clients")
    check(acc[-1] >= 0.85, f"final accuracy {acc[-1]} < 0.85")
    for agg in ("median", "trimmed"):
        h, ln, _, sec, pk = run_slice(torch, cu, sim_mod, 3, aggregator=agg)
        expect_launches(ln, delta_pipeline_apply=3)
        say("slice", aggregator=agg, rounds=3, k3_launches=ln["delta_pipeline_apply"],
            ms_per_round=sec / 3 * 1e3, accuracy=[round(a, 4) for a in h["accuracy"]])

    run_slice(torch, cu, sim_mod, 1, **POP_FOG)  # warm-up of the population path
    hist, launches, init_s, seconds, peak = run_slice(torch, cu, sim_mod, 20, **POP_FOG)
    expect_launches(launches, delta_pipeline_partial=80, delta_pipeline_apply=0,
                    delta_sq_norms=0)
    kernels[2]["launches"] = launches["delta_pipeline_partial"]
    acc = hist["accuracy"]
    say("slice", path="population+fog", population=POP_FOG["population"],
        cohort=POP_FOG["num_clients"], fog_nodes=POP_FOG["fog_nodes"], rounds=20,
        k4_launches=launches["delta_pipeline_partial"],
        k3_launches=launches["delta_pipeline_apply"],
        k2_launches=launches["delta_sq_norms"], init_s=init_s,
        ms_per_round=seconds / 20 * 1e3, peak_bytes=peak,
        accuracy=[round(a, 4) for a in acc], num_selected=hist["num_selected"])
    check(max(hist["num_selected"]) <= 24, "more than top-k = 24 clients selected")
    check(acc[-1] >= POP_FOG_MIN_ACCURACY,
          f"final accuracy {acc[-1]} < {POP_FOG_MIN_ACCURACY}")
    for name, over, want in (
        ("population, one fog", dict(POP_FOG, fog_nodes=1),
         dict(delta_pipeline_apply=3, delta_pipeline_partial=0)),
        ("dense, four fogs", dict(fog_nodes=4),
         dict(delta_pipeline_partial=12, delta_pipeline_apply=0)),
    ):
        h, ln, ini, sec, _ = run_slice(torch, cu, sim_mod, 3, **over)
        expect_launches(ln, **want)
        say("slice", path=repr(name), rounds=3, launches=ln, init_s=ini,
            ms_per_round=sec / 3 * 1e3, accuracy=[round(a, 4) for a in h["accuracy"]])

    # 5. result
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
