"""The client-sharded LM round on a world of ranks, against the
single-process round (port of ``repro/dist/selftest.py``).

    python -m repro_torch.dist.selftest --devices 8 --check --device cpu --json
    python -m repro_torch.dist.selftest --devices 2 --zero 1 --pallas-agg \\
        --gates legacy,legacy,full --device cuda --scale full --check --json

Spawns ``--devices`` ranks (``dist.world``; on the CUDA card unless
``--device cpu``) on the scaled plan
``plan_for(device_count=N, zero=Z)`` (``--fog-nodes F > 1`` makes it
multi-pod: the pod axis is the fog tier). Every rank builds the same
replicated state from ``--seed``, makes the same batches (numpy, seeded
by the seed and the round: ``BATCH_PER_SLOT`` sequences a slot and
local step) and runs one round per entry of ``--gates`` under a timed
``dist.CollectiveLog``,
whose contract it asserts each round: one delta-sized all-reduce
crossing the client ranks, one per tier with a fog tier. Each rank hands
back per round its metrics, kernel launches (the wrappers' ``launches``
counts of K2, K3 and K4, set to 0 just before the round and read just
after), peak device bytes, wall ms, the delta all-reduce's bytes and ms,
and fingerprints of the new parameters and server momentum: per leaf
the float64 sum, sum of squares and 4,096 seeded coordinates.

With ``--check`` the launcher, after the ranks exit, runs the
single-process port round (``C`` slots on one device) on the same inputs
and holds rank 0's fingerprints against it round by round. Rank 0 saves
its state before every round after the first (``--state-dir``, a fresh
temporary directory by default; ``checkpoint.save``), and the reference
starts each round from it, so every round is compared from the same
inputs: the slots' deltas are the same operations on the same data in
both runs, and only the order of the Eq. 6 sum differs. Tolerances:

  * float32 parameters (``--scale tiny``): 1e-4 absolute, the JAX
    selftest's bound;
  * bf16 parameters: one bf16 ulp of the reference value (the float32
    update differs in its last bits, and rounding to bf16 turns that into
    at most one ulp);
  * the float32 server momentum: 2⁻²⁰ (8 float32 ulps) of the leaf's
    largest |μ|: the two sums differ by a few roundings of terms no
    larger than that. With ``zero > 1`` a slot's gradient is itself the
    mean of its shares' gradients, another order of the batch's sums
    through every layer, so the deltas differ in their last bits and
    int8 may round one to the neighbouring quantum: the LM parity tests'
    tolerances hold then (``atol`` 2e-5, under int8 5e-4; ``rtol`` 1e-4);
  * each leaf's sum and sum of squares within what those per-element
    bounds allow.

Prints one JSON line with ``--json``; exits 0 when every check holds.
Median / trimmed and attacks are not ported under rules (item 11(b)).
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import tempfile
import time

import numpy as np

FINGERPRINT_COORDS = 4096
BATCH_PER_SLOT = 4  # sequences a slot trains on per local step
MU_TOL = 2.0 ** -20  # of the leaf's max |μ|, zero = 1
F32_ATOL, F32_RTOL = 2e-5, 1e-4  # zero > 1: the LM parity tests' MODEL_TOL
INT8_ATOL = 5e-4  # ... and their INT8_TOL under int8 compression
F32_PARAM_TOL = 1e-4


def gate_kwargs(preset: str) -> dict:
    """The JAX selftest's server-pipeline presets."""
    if preset == "full":  # DP + momentum + compression + clip
        return dict(server_optimizer="fedavgm", clip_norm=1.0, dp_sigma=1e-3,
                    compression="int8")
    if preset == "plain":  # bare FedAvg: every gate off
        return dict(server_optimizer="fedavg")
    if preset == "legacy":  # FedAvgM, nothing else
        return dict(server_optimizer="fedavgm")
    raise ValueError(f"unknown gates preset {preset!r}")


def model_config(arch: str, scale: str):
    """The assigned config at ``full`` (bf16), else the reduced one in
    float32 end to end, as the JAX selftest runs it."""
    from repro_torch.configs import get_config, get_reduced

    if scale == "full":
        return get_config(arch)
    return get_reduced(arch, loss_chunk=0, param_dtype="float32",
                       compute_dtype="float32")


def fl_config(slots: int, preset: str, *, pallas_agg: bool, fog_nodes: int,
              population, local_steps: int, faults=None):
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.fl import FLConfig

    # θ_d = 0.5 lets the batches' random histograms pass the drift gate, so
    # slots participate and the comparison is not of empty aggregates
    return FLConfig(num_clients=max(2 * slots, 8), slots=slots, local_steps=local_steps,
                    inner_optimizer="sgdm", use_pallas_agg=pallas_agg,
                    fog_nodes=fog_nodes, population=population, faults=faults,
                    scheduler=SchedulerConfig(theta_d=0.5), **gate_kwargs(preset))


def round_batch(cfg, fl_cfg, r: int, *, seed: int, seq_len: int, device) -> dict:
    """Round ``r``'s batch, made on the host from ``(seed, r)``: healthy
    telemetry, so clients pass the Eq. 3 gate."""
    import torch

    rng = np.random.default_rng([seed, r])
    n, c = fl_cfg.num_clients, fl_cfg.slots
    e = fl_cfg.local_steps
    b = {
        "tokens": rng.integers(0, cfg.vocab_size, (c * BATCH_PER_SLOT * e, seq_len + 1)),
        "slot_data_sizes": rng.uniform(50, 300, c).astype(np.float32),
        "telemetry_cpu": rng.uniform(0.4, 1.0, n).astype(np.float32),
        "telemetry_mem": rng.uniform(0.4, 1.0, n).astype(np.float32),
        "telemetry_batt": rng.uniform(0.3, 1.0, n).astype(np.float32),
        "telemetry_energy": rng.uniform(0.4, 1.0, n).astype(np.float32),
        "hist": (np.abs(rng.standard_normal((n, fl_cfg.hist_bins))) + 1.0).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def fingerprint(leaves, seed: int = 0) -> list[dict]:
    """Per leaf: float64 sum and sum of squares, and the values at
    ``FINGERPRINT_COORDS`` seeded coordinates (with their indices)."""
    import torch

    out = []
    for i, x in enumerate(leaves):
        flat = x.reshape(-1)
        idx = np.random.default_rng([seed, i]).integers(0, flat.numel(), FINGERPRINT_COORDS)
        d = flat.double() if flat.numel() <= (1 << 26) else None
        s = ss = 0.0
        for lo in range(0, flat.numel(), 1 << 26):  # float64 in windows
            w = d[lo:lo + (1 << 26)] if d is not None else flat[lo:lo + (1 << 26)].double()
            s += float(torch.sum(w))
            ss += float(torch.sum(w * w))
        vals = flat[torch.from_numpy(idx).to(flat.device)].double().cpu().numpy()
        out.append(dict(sum=s, sumsq=ss, idx=idx, vals=vals, dtype=str(x.dtype)))
    return out


def _counts() -> dict:
    from repro_torch.kernels.delta_pipeline import delta_pipeline as cu

    return {"delta_sq_norms": cu.delta_sq_norms_cuda.launches,
            "delta_pipeline_apply": cu.launch_pipeline.launches,
            "delta_pipeline_partial": cu.launch_partial.launches}


def _zero_counts() -> None:
    from repro_torch.kernels.delta_pipeline import delta_pipeline as cu

    cu.delta_sq_norms_cuda.launches = cu.launch_pipeline.launches = 0
    cu.launch_partial.launches = 0


def rank_rounds(ctx, spec: dict) -> list[dict]:
    """One rank of the selftest: ``spec`` is :func:`run_selftest`'s options.
    Returns one record a round (see the module docstring)."""
    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch import tree
    from repro_torch.dist import (CollectiveLog, assert_inter_client_contract,
                                  inter_client_all_reduces, make_rules)
    from repro_torch.fl import init_fl_state, make_round_fn
    from repro_torch.launch.train import host_metrics
    from repro_torch.models import build_model
    from repro_torch.random import TorchDraws

    cfg = model_config(spec["arch"], spec["scale"])
    model = build_model(cfg)
    fog = spec["fog_nodes"]
    rules = make_rules(None, cfg, multi_pod=fog > 1, device_count=ctx.world_size,
                       zero=spec["zero"], backend=ctx.backend, device=ctx.device)
    slots = rules.plan.num_clients
    cfgs = {g: fl_config(slots, g, pallas_agg=spec["pallas_agg"], fog_nodes=fog,
                         population=spec["population"], local_steps=spec["local_steps"])
            for g in dict.fromkeys(spec["gates"])}
    draws = TorchDraws(spec["seed"], ctx.device)
    fns = {g: make_round_fn(model, f, rules=rules, draws=draws) for g, f in cfgs.items()}
    state = init_fl_state(model, cfgs[spec["gates"][0]], spec["seed"], device=ctx.device,
                          rules=rules)
    p = model.param_count()
    records = []
    cuda = ctx.device.type == "cuda"
    for r, g in enumerate(spec["gates"]):
        if spec["state_dir"] and r > 0:
            if ctx.rank == 0:
                ckpt.save(spec["state_dir"], r, state)
            # the other ranks wait here, not inside the timed round
            torch.distributed.barrier()
        batch = round_batch(cfg, cfgs[g], r, seed=spec["seed"], seq_len=spec["seq_len"],
                            device=ctx.device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        with CollectiveLog(timed=True) as log, torch.no_grad():
            state, metrics = fns[g](state, batch)
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _counts()
        try:
            n_ar, delta_bytes = assert_inter_client_contract(log, rules, p, fog)
            contract_error = None
        except AssertionError as e:
            n_ar, delta_bytes = inter_client_all_reduces(log, rules, p)
            contract_error = str(e)
        delta_ops = [op for op in log.ops if op.bytes >= 0.5 * delta_bytes]
        del batch
        records.append(dict(
            gates=g, metrics=host_metrics(metrics), launches=launches, round_ms=ms,
            peak_bytes=torch.cuda.max_memory_allocated() if cuda else None,
            contract_error=contract_error, inter_client_all_reduces=n_ar,
            delta_all_reduces=[dict(bytes=op.bytes, ms=op.ms, ranks=op.groups[0])
                               for op in delta_ops],
            collectives=log.stats().count_by_kind,
            params=fingerprint(tree.leaves(state.params), spec["seed"]),
            server_mu=(None if state.server_mu is None else
                       fingerprint(tree.leaves(state.server_mu), spec["seed"] + 1)),
        ))
    return records


def element_bound(leaf, kind: str, *, zero: int = 1, int8: bool = False):
    """The per-element bound (float64, on the leaf's device) of rank 0's
    value against the reference ``leaf`` (see the module docstring)."""
    import torch

    b = leaf.double().abs()
    if kind == "server_mu":
        if zero == 1:
            return torch.full_like(b, MU_TOL * float(torch.max(b)))
        atol = INT8_ATOL if int8 else F32_ATOL
        return atol + F32_RTOL * b
    if leaf.dtype == torch.bfloat16:
        return torch.exp2(torch.floor(torch.log2(
            torch.clamp(b, min=float(np.finfo(np.float32).tiny)))) - 7)
    return torch.full_like(b, F32_PARAM_TOL)


def _hold(fp, ref_leaves, ref_fp, kind: str, **bound_kw) -> dict:
    """Rank 0's fingerprints against the reference leaves: each sampled
    value within its element bound, each leaf's sum within the sum of the
    bounds and its sum of squares within Σ bound·(2|x| + bound). Returns
    whether all hold, the largest error and the worst share of a bound."""
    import torch

    worst, max_err, ok = 0.0, 0.0, True
    for a, b, leaf in zip(fp, ref_fp, ref_leaves):
        bound = element_bound(leaf, kind, **bound_kw).reshape(-1)
        tol = bound[torch.from_numpy(a["idx"]).to(bound.device)].cpu().numpy()
        tol_sum = float(torch.sum(bound))
        tol_sumsq = float(torch.sum(bound * (2.0 * leaf.double().abs().reshape(-1) + bound)))
        del bound
        err = np.abs(a["vals"] - b["vals"])
        max_err = max(max_err, float(err.max()))
        worst = max(worst, float((err / tol).max()))
        ok = (ok and bool((err <= tol).all()) and abs(a["sum"] - b["sum"]) <= tol_sum
              and abs(a["sumsq"] - b["sumsq"]) <= tol_sumsq)
    return dict(ok=ok, max_abs_err=max_err, worst_share_of_tol=worst)


def reference_rounds(spec: dict, rank0: list[dict], device) -> list[dict]:
    """The single-process port round (every slot on one device) from rank
    0's state before each round, on the same batch; rank 0's fingerprints
    held against it."""
    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch import tree
    from repro_torch.dist.meshes import plan_for
    from repro_torch.fl import init_fl_state, make_round_fn
    from repro_torch.launch.train import host_metrics
    from repro_torch.models import build_model
    from repro_torch.random import TorchDraws

    cfg = model_config(spec["arch"], spec["scale"])
    model = build_model(cfg)
    plan = plan_for(cfg, multi_pod=spec["fog_nodes"] > 1, device_count=spec["devices"],
                    zero=spec["zero"])
    cfgs = {g: fl_config(plan.num_clients, g, pallas_agg=spec["pallas_agg"],
                         fog_nodes=spec["fog_nodes"], population=spec["population"],
                         local_steps=spec["local_steps"])
            for g in dict.fromkeys(spec["gates"])}
    draws = TorchDraws(spec["seed"], device)
    out = []
    for r, g in enumerate(spec["gates"]):
        state = init_fl_state(model, cfgs[spec["gates"][0]], spec["seed"], device=device)
        if r > 0:
            state = ckpt.restore(spec["state_dir"], r, state)
        batch = round_batch(cfg, cfgs[g], r, seed=spec["seed"], seq_len=spec["seq_len"],
                            device=device)
        fn = make_round_fn(model, cfgs[g], draws=draws)
        with torch.no_grad():
            state, metrics = fn(state, batch)
        del batch
        m_ref = host_metrics(metrics)
        m_rank = rank0[r]["metrics"]
        metric_err = {k: abs(m_rank[k] - v) for k, v in m_ref.items()}
        metrics_ok = all(e <= 1e-3 * (1.0 + abs(m_ref[k])) for k, e in metric_err.items())
        params = tree.leaves(state.params)
        held = dict(round=r, gates=g, metrics_ok=metrics_ok,
                    metric_diffs={k: float(f"{e:.3e}") for k, e in metric_err.items()},
                    params=_hold(rank0[r]["params"], params,
                                 fingerprint(params, spec["seed"]), "params"))
        if state.server_mu is not None:
            mu = tree.leaves(state.server_mu)
            held["server_mu"] = _hold(rank0[r]["server_mu"], mu,
                                      fingerprint(mu, spec["seed"] + 1), "server_mu",
                                      zero=plan.zero,
                                      int8=cfgs[g].compression == "int8")
        held["ok"] = bool(metrics_ok and held["params"]["ok"]
                          and held.get("server_mu", {"ok": True})["ok"])
        out.append(held)
        del state, params
    return out


def _same_fingerprints(a: list, b: list) -> bool:
    return all(x["sum"] == y["sum"] and x["sumsq"] == y["sumsq"]
               and np.array_equal(x["vals"], y["vals"]) for x, y in zip(a, b))


def run_selftest(arch: str = "llama3.2-1b", devices: int = 8, *, zero: int | None = None,
                 fog_nodes: int = 1, population: int | None = None,
                 gates=("legacy",), pallas_agg: bool = False, check: bool = True,
                 device=None, backend: str = "gloo", scale: str = "tiny",
                 seq_len: int = 32, local_steps: int = 1, seed: int = 0,
                 state_dir: str | None = None) -> dict:
    """The selftest (see the module docstring) on ``device``: None the
    CUDA card, the CPU only when asked for by name."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.dist.meshes import plan_for
    from repro_torch.dist.world import spawn
    from repro_torch.models import build_model

    dev = resolve_device(device)
    cfg = model_config(arch, scale)
    plan = plan_for(cfg, multi_pod=fog_nodes > 1, device_count=devices, zero=zero)
    own_dir = check and state_dir is None
    if own_dir:
        state_dir = tempfile.mkdtemp(prefix="fedfog_selftest_")
    spec = dict(arch=arch, scale=scale, devices=devices, zero=plan.zero,
                fog_nodes=fog_nodes, population=population, gates=list(gates),
                pallas_agg=pallas_agg, seq_len=seq_len, local_steps=local_steps, seed=seed, state_dir=state_dir if check else None)
    try:
        t0 = time.perf_counter()
        per_rank = spawn(rank_rounds, devices, spec, backend=backend, device=dev,
                         timeout=3600.0)
        world_s = time.perf_counter() - t0
        rank0 = per_rank[0]
        replicated = all(_same_fingerprints(r[i]["params"], rank0[i]["params"])
                         for r in per_rank for i in range(len(rank0)))
        contract_ok = all(rec["contract_error"] is None for r in per_rank for rec in r)
        losses = [rec["metrics"]["loss"] for rec in rank0]
        result = dict(
            arch=arch, scale=scale, devices=devices, device=str(dev), backend=backend,
            param_count=build_model(cfg).param_count(),
            plan=dict(shape=plan.shape, num_clients=plan.num_clients, zero=plan.zero,
                      client_axes=list(plan.client_axes)),
            fog_nodes=fog_nodes, population=population, pallas_agg=pallas_agg,
            gates=list(gates), world_s=world_s, losses=losses,
            participation=[rec["metrics"]["slot_participation"] for rec in rank0],
            contract_errors=[rec["contract_error"] for r in per_rank for rec in r
                             if rec["contract_error"]],
            inter_client_all_reduces=[[rec["inter_client_all_reduces"] for rec in r]
                                      for r in per_rank],
            delta_all_reduces=[[rec["delta_all_reduces"] for rec in r] for r in per_rank],
            launches=[[rec["launches"] for rec in r] for r in per_rank],
            round_ms=[[rec["round_ms"] for rec in r] for r in per_rank],
            peak_bytes=[[rec["peak_bytes"] for rec in r] for r in per_rank],
            collectives=rank0[0]["collectives"],
            replicated=replicated,
        )
        ok = contract_ok and replicated and all(math.isfinite(x) for x in losses)
        if check:
            del per_rank
            if dev.type == "cuda":
                torch.cuda.set_device(0)
            # on the CPU with the ranks' one intra-op thread: a product split
            # over more threads sums in another order
            threads = torch.get_num_threads()
            if dev.type == "cpu":
                torch.set_num_threads(1)
            t0 = time.perf_counter()
            try:
                held = reference_rounds(spec, rank0, dev)
            finally:
                torch.set_num_threads(threads)
            result["reference_s"] = time.perf_counter() - t0
            result["check"] = held
            ok = ok and all(h["ok"] for h in held)
        result["ok"] = bool(ok)
        return result
    finally:
        if own_dir:
            shutil.rmtree(state_dir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--scale", default="tiny", choices=("tiny", "full"))
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--zero", type=int, default=None)
    ap.add_argument("--fog-nodes", type=int, default=1,
                    help="fog-tier width (multi-pod plan; pod axis = fog)")
    ap.add_argument("--population", type=int, default=None)
    ap.add_argument("--gates", default="legacy",
                    help="a preset (plain|legacy|full) or one per round, comma-separated")
    ap.add_argument("--pallas-agg", action="store_true",
                    help="route the server pass through delta_pipeline_apply_sharded")
    ap.add_argument("--check", action="store_true",
                    help="hold rank 0 against the single-process round")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="default: the CUDA card; 'cpu' to ask for the CPU")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--state-dir", default=None,
                    help="where rank 0 leaves its pre-round states for --check")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    res = run_selftest(
        args.arch, args.devices, zero=args.zero, fog_nodes=args.fog_nodes,
        population=args.population, gates=args.gates.split(","),
        pallas_agg=args.pallas_agg, check=args.check, device=args.device,
        backend=args.backend, scale=args.scale, seq_len=args.seq_len,
        local_steps=args.local_steps, seed=args.seed, state_dir=args.state_dir)
    if args.json:
        print(json.dumps(res))
    else:
        for k, v in res.items():
            print(f"{k}: {v}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
