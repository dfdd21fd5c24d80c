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

Tensor axes: ``--model-split T,S`` builds the ``MeshPlan`` directly,
``client = devices / (zero · T · S)`` by ``zero`` by (tp T, sp S): a
model split that ``plan_for`` gives only the production pool (256
chips), reachable so on a small world. Each rank then holds its blocks
of the parameters and the momentum (``dist.tensor_parallel``); the
fingerprints and the saved states are of the whole trees, gathered over
each model group. A rank also reports the tensor-axis collectives of
its local training per local step (count, bytes, wall ms) and the
server pass's gathers. Held against the single-process round:

  * float32: the LM parity tolerances, as with ``zero > 1`` (the
    row-parallel partial sums add in another order through every layer);
  * bf16: the layers' partial sums are rounded to bf16 before they are
    reduced, another set of bf16 roundings than the single process
    makes; where a leaf's gradient is a sum that cancels (a norm scale,
    which starts at 0) that moves a coordinate by a large share of its
    update. So rank 0 is held against the truth both runs approximate:
    the reference also runs the round in float32 from the same pre-round
    state (cast), and per leaf the rms over the sampled coordinates of
    rank 0's distance to it must be within ``BF16_TP_FACTOR`` times the
    single-process bf16 round's (``_hold_truth``): the tensor-parallel
    round is no further from float32 than the plain one is, to that
    factor. A missing or doubled reduction moves a leaf by its whole
    update, far past that.

``--mode step`` checks one local step only, for configurations whose
whole round does not fit beside a second rank: every rank computes the
loss and the gradient of the same ``BATCH_PER_SLOT`` sequences on its
blocks, the gradient is gathered whole, and rank 0's loss and gradient
fingerprints are held against the single-process model's (float32:
``STEP_TOL``; bf16: ``_hold_truth`` against the float32 gradient of the
same parameters; the loss within ``LOSS_RTOL``). ``--layers N`` cuts
the depth (printed in the result), ``--dtype float32`` runs a full-width
config in float32 (how the bf16 bound was measured).

``--mode serve`` runs serving under mesh rules instead of the round
(``dist.serve_selftest``: the static engine for each ``--batch``, the
continuous one with ``--engine ...,continuous``, held against the
single-process engines).

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
BF16_TP_FACTOR = 2.0  # bf16 with a model split: see _hold_truth
STEP_TOL = (1e-4, 1e-5)  # --mode step, float32: rtol of |g|, share of the leaf's max |g|
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -8}  # --mode step's loss


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


def model_config(arch: str, scale: str, *, dtype: str | None = None,
                 layers: int | None = None):
    """The assigned config at ``full`` (bf16, or ``dtype``), else the
    reduced one in float32 end to end, as the JAX selftest runs it;
    ``layers`` cuts the depth."""
    import dataclasses

    from repro_torch.configs import get_config, get_reduced

    if scale == "full":
        cfg = get_config(arch)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    else:
        cfg = get_reduced(arch, loss_chunk=0, param_dtype="float32",
                          compute_dtype="float32")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg


def spec_config(spec: dict):
    return model_config(spec["arch"], spec["scale"], dtype=spec.get("dtype"),
                        layers=spec.get("layers"))


def selftest_plan(cfg, devices: int, *, zero, fog_nodes: int, model_split=None):
    """``plan_for(device_count=devices)``, or with ``model_split`` (T, S)
    the ``MeshPlan`` of ``devices / (zero·T·S)`` clients (``zero`` None:
    1) by zero by (tp T, sp S), the pod axis 2 with a fog tier."""
    from repro_torch.dist.meshes import MeshPlan, plan_for

    if model_split is None:
        return plan_for(cfg, multi_pod=fog_nodes > 1, device_count=devices, zero=zero)
    t, sp = model_split
    z = zero or 1
    pods = 2 if fog_nodes > 1 else 1
    if devices % (z * t * sp * pods):
        raise ValueError(f"{devices} devices do not divide into {pods} pod(s) x zero {z} "
                         f"x tp {t} x sp {sp}")
    return MeshPlan(num_pods=pods, num_clients=devices // (z * t * sp), zero=z,
                    model_axes=("tp", "sp"), model_split=(t, sp))


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
    from repro_torch.dist.collectives import tensor_axis_summary
    from repro_torch.dist.tensor_parallel import TensorParallel
    from repro_torch.fl import init_fl_state, make_round_fn
    from repro_torch.fl.state import whole_state
    from repro_torch.launch.train import host_metrics
    from repro_torch.models import build_model
    from repro_torch.random import TorchDraws

    cfg = spec_config(spec)
    model = build_model(cfg)
    fog = spec["fog_nodes"]
    plan = selftest_plan(cfg, ctx.world_size, zero=spec["zero"], fog_nodes=fog,
                         model_split=spec.get("model_split"))
    rules = make_rules(None, cfg, plan=plan, backend=ctx.backend, device=ctx.device)
    tp = TensorParallel.from_rules(rules)
    if spec.get("mode", "round") == "step":
        return rank_step(ctx, spec, cfg, model, rules, tp)
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
        delta_ops = [op for op in log.ops if op.bytes >= 0.5 * delta_bytes
                     and op.kind == "all-reduce"]
        del batch
        whole = whole_state(state, tp)  # the model group's blocks, gathered
        if spec["state_dir"] and r + 1 < len(spec["gates"]):
            if ctx.rank == 0:  # the next round's inputs, for the reference
                ckpt.save(spec["state_dir"], r + 1, whole)
            # the other ranks wait here, not inside the timed round
            torch.distributed.barrier()
        steps = (slots // rules.client_ways) * spec["local_steps"]
        records.append(dict(
            gates=g, metrics=host_metrics(metrics), launches=launches, round_ms=ms,
            peak_bytes=torch.cuda.max_memory_allocated() if cuda else None,
            contract_error=contract_error, inter_client_all_reduces=n_ar,
            delta_all_reduces=[dict(bytes=op.bytes, ms=op.ms, ranks=op.groups[0])
                               for op in delta_ops],
            collectives=log.stats().count_by_kind,
            tensor_axis=(None if tp is None else dict(
                per_local_step=tensor_axis_summary(log, rules, steps),
                gather=tensor_axis_summary(log, rules, 1, phase="gather"))),
            params=fingerprint(tree.leaves(whole.params), spec["seed"]),
            server_mu=(None if whole.server_mu is None else
                       fingerprint(tree.leaves(whole.server_mu), spec["seed"] + 1)),
        ))
        del whole
    return records


def step_batch(cfg, spec: dict, device) -> dict:
    """The one-step check's batch: the first ``BATCH_PER_SLOT`` sequences of
    round 0's tokens (the same on every rank)."""
    import torch

    rng = np.random.default_rng([spec["seed"], 0])
    toks = rng.integers(0, cfg.vocab_size, (BATCH_PER_SLOT, spec["seq_len"] + 1))
    return {"tokens": torch.from_numpy(toks).to(device)}


def loss_and_grads(model, params, batch, runtime=None):
    """The loss and the gradient leaves of one step (as the round's
    ``_value_and_grad``)."""
    import torch

    from repro_torch import tree
    from repro_torch.models import Runtime

    leaves = [t.detach().requires_grad_(True) for t in tree.leaves(params)]
    with torch.enable_grad():
        loss = model.loss(tree.unflatten(params, leaves), batch, runtime or Runtime())
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree.unflatten(params, list(grads))


def rank_step(ctx, spec, cfg, model, rules, tp) -> list[dict]:
    """``--mode step`` on one rank: the loss and the gathered gradient of
    one local step on this rank's blocks; one record."""
    import torch

    from repro_torch import tree
    from repro_torch.dist import CollectiveLog
    from repro_torch.dist.collectives import labelled, tensor_axis_summary
    from repro_torch.fl.state import FLConfig, init_fl_state
    from repro_torch.models import Runtime

    state = init_fl_state(model, FLConfig(num_clients=rules.plan.num_clients,
                                          slots=rules.plan.num_clients),
                          spec["seed"], device=ctx.device, rules=rules, server_mu=False)
    batch = step_batch(cfg, spec, ctx.device)
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with CollectiveLog(timed=True) as log, labelled("local_training"):
        loss, grads = loss_and_grads(model, state.params, batch, Runtime(tensor=tp))
    if cuda:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() if cuda else None
    del state
    whole = grads if tp is None else tp.gather_tree(grads)
    return [dict(loss=float(loss), step_ms=ms, peak_bytes=peak,
                 tensor_axis=None if tp is None else tensor_axis_summary(log, rules, 1),
                 grads=fingerprint(tree.leaves(whole), spec["seed"] + 2))]


def element_bound(leaf, kind: str, *, zero: int = 1, int8: bool = False,
                  tensor: bool = False):
    """The per-element bound (float64, on the leaf's device) of rank 0's
    value against the reference ``leaf`` (see the module docstring).
    ``tensor``: the run had a model split (float32 leaves; bf16 ones are
    held by :func:`_hold_truth`)."""
    import torch

    b = leaf.double().abs()
    if kind == "server_mu":
        if zero == 1 and not tensor:
            return torch.full_like(b, MU_TOL * float(torch.max(b)))
        atol = INT8_ATOL if int8 else F32_ATOL
        return atol + F32_RTOL * b
    if leaf.dtype == torch.bfloat16:
        return torch.exp2(torch.floor(torch.log2(
            torch.clamp(b, min=float(np.finfo(np.float32).tiny)))) - 7)
    if tensor:
        return (INT8_ATOL if int8 else F32_ATOL) + F32_RTOL * b
    return torch.full_like(b, F32_PARAM_TOL)


def _hold(fp, ref_leaves, ref_fp, kind: str, bound_fn=None, **bound_kw) -> dict:
    """Rank 0's fingerprints against the reference leaves: each sampled
    value within its element bound, each leaf's sum within the sum of the
    bounds and its sum of squares within Σ bound·(2|x| + bound). Returns
    whether all hold, the largest error and the worst share of a bound.
    ``bound_fn(leaf)``: another bound than ``element_bound``."""
    import torch

    worst, max_err, ok = 0.0, 0.0, True
    for a, b, leaf in zip(fp, ref_fp, ref_leaves):
        bound = (bound_fn(leaf) if bound_fn is not None else
                 element_bound(leaf, kind, **bound_kw)).reshape(-1)
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


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(x))))


def _hold_truth(fp, ref_fp, f32_fp) -> dict:
    """bf16 under a model split: per leaf, rank 0's rms distance over the
    sampled coordinates to the float32 round's values within
    ``BF16_TP_FACTOR`` times the single-process bf16 round's, plus a
    floor of 2⁻¹⁶ of the float32 values' rms (a leaf both runs get exactly
    right). Returns whether every leaf holds, the worst share of its
    bound, the worst ratio of the two distances and the largest
    difference from the bf16 reference."""
    worst = ratio = max_err = 0.0
    ok = True
    for a, b, t in zip(fp, ref_fp, f32_fp):
        mine, plain = _rms(a["vals"] - t["vals"]), _rms(b["vals"] - t["vals"])
        tol = BF16_TP_FACTOR * plain + 2.0 ** -16 * _rms(t["vals"])
        ok = ok and mine <= tol
        worst = max(worst, mine / tol if tol > 0 else (0.0 if mine == 0 else np.inf))
        ratio = max(ratio, mine / plain if plain > 0 else 0.0)
        max_err = max(max_err, float(np.abs(a["vals"] - b["vals"]).max()))
    return dict(ok=bool(ok), worst_share_of_tol=worst, worst_rms_ratio=ratio,
                max_abs_err=max_err)


def _as_float32(state):
    """A state's parameters widened to float32 (the momentum is float32),
    each a copy, the momentum in one flat buffer as the round keeps it."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.fl.state import flat_zeros_like

    params = tree.map(lambda x: x.float().clone(), state.params)
    mu = None
    if state.server_mu is not None:
        mu = flat_zeros_like(params)
        for dst, src in zip(tree.leaves(mu), tree.leaves(state.server_mu)):
            dst.copy_(src)
    return dataclasses.replace(state, params=params, server_mu=mu)


def reference_rounds(spec: dict, rank0: list[dict], device) -> list[dict]:
    """The single-process port round (every slot on one device) from rank
    0's state before each round, on the same batch; rank 0's fingerprints
    held against it."""
    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch import tree
    from repro_torch.fl import init_fl_state, make_round_fn
    from repro_torch.launch.train import host_metrics
    from repro_torch.models import build_model
    from repro_torch.random import TorchDraws

    cfg = spec_config(spec)
    model = build_model(cfg)
    plan = selftest_plan(cfg, spec["devices"], zero=spec["zero"],
                         fog_nodes=spec["fog_nodes"], model_split=spec.get("model_split"))
    tensor = plan.model_ways > 1
    truth = tensor and cfg.param_dtype == "bfloat16"  # also run it in float32
    model32 = build_model(_float32(cfg)) if truth else None
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
        pre32 = _as_float32(state) if truth else None
        with torch.no_grad():
            state, metrics = fn(state, batch)
        m_ref = host_metrics(metrics)
        m_rank = rank0[r]["metrics"]
        metric_err = {k: abs(m_rank[k] - v) for k, v in m_ref.items()}
        metrics_ok = all(e <= 1e-3 * (1.0 + abs(m_ref[k])) for k, e in metric_err.items())
        held = dict(round=r, gates=g, metrics_ok=metrics_ok,
                    metric_diffs={k: float(f"{e:.3e}") for k, e in metric_err.items()})
        parts = [("params", 0)] + ([("server_mu", 1)] if state.server_mu is not None else [])
        if truth:  # the same round in float32 from the same state, widened
            refs = {k: fingerprint(tree.leaves(getattr(state, k)), spec["seed"] + o)
                    for k, o in parts}
            del state
            with torch.no_grad():
                state, _ = make_round_fn(model32, cfgs[g], draws=draws)(pre32, batch)
            del pre32
            for k, o in parts:
                held[k] = _hold_truth(rank0[r][k], refs[k], fingerprint(
                    tree.leaves(getattr(state, k)), spec["seed"] + o))
        else:
            for k, o in parts:
                leaves = tree.leaves(getattr(state, k))
                held[k] = _hold(rank0[r][k], leaves, fingerprint(leaves, spec["seed"] + o), k,
                                zero=plan.zero, tensor=tensor,
                                int8=cfgs[g].compression == "int8")
        held["ok"] = bool(metrics_ok and all(held[k]["ok"] for k, _ in parts))
        out.append(held)
        del state, batch
    return out


def _float32(cfg):
    import dataclasses

    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def reference_step(spec: dict, rank0: dict, device) -> dict:
    """``--mode step``'s single-process loss and gradient from the same
    initial parameters and batch; rank 0's held against them: in float32
    each sampled gradient value within ``STEP_TOL``, in bf16 (a model
    split) per leaf against the float32 gradient of the same parameters
    widened (``_hold_truth``); the loss within ``LOSS_RTOL``."""
    import torch

    from repro_torch import tree
    from repro_torch.fl.state import FLConfig, init_fl_state
    from repro_torch.models import build_model

    cfg = spec_config(spec)
    model = build_model(cfg)
    state = init_fl_state(model, FLConfig(num_clients=1, slots=1), spec["seed"],
                          device=device, server_mu=False)
    batch = step_batch(cfg, spec, device)
    loss, grads = loss_and_grads(model, state.params, batch)
    leaves = tree.leaves(grads)
    ref_fp = fingerprint(leaves, spec["seed"] + 2)
    if cfg.param_dtype == "bfloat16":
        del grads, leaves
        params32 = tree.map(lambda x: x.float(), state.params)
        del state
        _, grads32 = loss_and_grads(build_model(_float32(cfg)), params32, batch)
        held = _hold_truth(rank0["grads"], ref_fp, fingerprint(tree.leaves(grads32),
                                                                spec["seed"] + 2))
        del params32, grads32
    else:
        del state
        rtol, share = STEP_TOL

        def bound(g):
            b = g.double().abs()
            return rtol * b + share * float(torch.max(b))

        held = _hold(rank0["grads"], leaves, ref_fp, "grads", bound_fn=bound)
    loss_rtol = LOSS_RTOL[cfg.param_dtype]
    loss_err = abs(rank0["loss"] - float(loss))
    held.update(loss=float(loss), loss_err=loss_err,
                loss_ok=loss_err <= loss_rtol * abs(float(loss)))
    held["ok"] = bool(held["ok"] and held["loss_ok"])
    return held


def _same_fingerprints(a: list, b: list) -> bool:
    return all(x["sum"] == y["sum"] and x["sumsq"] == y["sumsq"]
               and np.array_equal(x["vals"], y["vals"]) for x, y in zip(a, b))


def run_selftest(arch: str = "llama3.2-1b", devices: int = 8, *, zero: int | None = None,
                 fog_nodes: int = 1, population: int | None = None,
                 gates=("legacy",), pallas_agg: bool = False, check: bool = True,
                 device=None, backend: str = "gloo", scale: str = "tiny",
                 seq_len: int = 32, local_steps: int = 1, seed: int = 0,
                 state_dir: str | None = None, model_split=None, mode: str = "round",
                 dtype: str | None = None, layers: int | None = None) -> dict:
    """The selftest (see the module docstring) on ``device``: None the
    CUDA card, the CPU only when asked for by name."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.dist.world import spawn
    from repro_torch.models import build_model

    dev = resolve_device(device)
    cfg = model_config(arch, scale, dtype=dtype, layers=layers)
    plan = selftest_plan(cfg, devices, zero=zero, fog_nodes=fog_nodes,
                         model_split=model_split)
    own_dir = check and state_dir is None and mode == "round"
    if own_dir:
        state_dir = tempfile.mkdtemp(prefix="fedfog_selftest_")
    spec = dict(arch=arch, scale=scale, devices=devices, zero=plan.zero,
                fog_nodes=fog_nodes, population=population, gates=list(gates),
                pallas_agg=pallas_agg, seq_len=seq_len, local_steps=local_steps, seed=seed,
                state_dir=state_dir if check else None,
                model_split=None if model_split is None else tuple(model_split),
                mode=mode, dtype=dtype, layers=layers)
    if mode == "step":
        return _run_step(spec, cfg, plan, dev, backend, check)
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
            param_count=build_model(cfg).param_count(), layers=cfg.num_layers,
            dtype=cfg.param_dtype,
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
            tensor_axis=[[rec["tensor_axis"] for rec in r] for r in per_rank],
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


def _run_step(spec, cfg, plan, dev, backend, check) -> dict:
    """``--mode step`` (see the module docstring)."""
    import torch

    from repro_torch.dist.world import spawn
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    per_rank = [r[0] for r in spawn(rank_rounds, spec["devices"], spec, backend=backend,
                                    device=dev, timeout=3600.0)]
    result = dict(
        arch=spec["arch"], scale=spec["scale"], mode="step", devices=spec["devices"],
        device=str(dev), backend=backend, layers=cfg.num_layers, dtype=cfg.param_dtype,
        param_count=build_model(cfg).param_count(), plan=dict(shape=plan.shape),
        world_s=time.perf_counter() - t0, losses=[r["loss"] for r in per_rank],
        step_ms=[r["step_ms"] for r in per_rank], peak_bytes=[r["peak_bytes"] for r in per_rank],
        tensor_axis=[r["tensor_axis"] for r in per_rank],
        replicated=all(_same_fingerprints(r["grads"], per_rank[0]["grads"])
                       and r["loss"] == per_rank[0]["loss"] for r in per_rank))
    ok = result["replicated"] and all(math.isfinite(x) for x in result["losses"])
    if check:
        if dev.type == "cuda":
            torch.cuda.set_device(0)
        threads = torch.get_num_threads()
        if dev.type == "cpu":
            torch.set_num_threads(1)
        t0 = time.perf_counter()
        try:
            result["check"] = reference_step(spec, per_rank[0], dev)
        finally:
            torch.set_num_threads(threads)
        result["reference_s"] = time.perf_counter() - t0
        ok = ok and result["check"]["ok"]
    result["ok"] = bool(ok)
    return result


def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"{type(x)} is not JSON serializable")


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
    ap.add_argument("--model-split", default=None,
                    help="T,S: a MeshPlan with tp T and sp S (client = devices / "
                         "(zero*T*S)); the DENSE family only")
    ap.add_argument("--mode", default="round", choices=("round", "step", "serve"),
                    help="step: one local step's loss and gradient only; serve: serving "
                         "under the rules (dist.serve_selftest)")
    ap.add_argument("--engine", default="static",
                    help="--mode serve: static, continuous or both, comma-separated")
    ap.add_argument("--batch", default="4",
                    help="--mode serve: the static batch, or several comma-separated")
    ap.add_argument("--slots", type=int, default=4, help="--mode serve: continuous slots")
    ap.add_argument("--requests", type=int, default=8,
                    help="--mode serve: the continuous engine's trace length")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8, help="--mode serve: tokens a request")
    ap.add_argument("--attn", default="dense", choices=("dense", "paged"),
                    help="--mode serve: the continuous engine's decode attention (paged: K7)")
    ap.add_argument("--flash", action="store_true",
                    help="--mode serve: prefill through K5 (attn_impl='flash')")
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="--scale full in this dtype (default the config's bf16)")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    split = (None if args.model_split is None
             else tuple(int(x) for x in args.model_split.split(",")))
    if args.mode == "serve":
        from repro_torch.dist.serve_selftest import run_serve

        res = run_serve(
            args.arch, args.devices, engines=args.engine.split(","),
            batches=[int(x) for x in args.batch.split(",")], slots=args.slots,
            requests=args.requests, prompt_len=args.prompt_len, gen=args.gen,
            attn=args.attn, flash=args.flash, model_split=split, check=args.check,
            device=args.device, backend=args.backend, scale=args.scale, dtype=args.dtype,
            layers=args.layers, seed=args.seed)
        print(json.dumps(res, default=_jsonable) if args.json else res)
        return 0 if res["ok"] else 1
    res = run_selftest(
        args.arch, args.devices, zero=args.zero, fog_nodes=args.fog_nodes,
        population=args.population, gates=args.gates.split(","),
        pallas_agg=args.pallas_agg, check=args.check, device=args.device,
        backend=args.backend, scale=args.scale, seq_len=args.seq_len,
        local_steps=args.local_steps, seed=args.seed, state_dir=args.state_dir,
        model_split=split, mode=args.mode, dtype=args.dtype, layers=args.layers)
    if args.json:
        print(json.dumps(res))
    else:
        for k, v in res.items():
            print(f"{k}: {v}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
