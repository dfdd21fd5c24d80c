"""Where one round of the port's LM training path spends its time on the
card.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_train [--rounds 2]
        [launch/train.py flags, e.g. --fog-nodes 2 --population 1000000]

Builds ``launch/train.py``'s run at ``--scale full --pallas-agg`` (the
flags after the tool's own go to the launcher's parser), runs one warm-up
round, then:

  * ``--rounds`` unprofiled rounds: the host clock around each, between
    two device synchronisations;
  * ``--rounds`` rounds under ``torch.profiler``: device kernel time per
    round, the device's busy share (kernel time over the profiled wall
    time), kernel launches per round, device time by kind (GEMMs, the
    delta-pipeline kernels, the rest), the kernels that take the most
    device time, and per phase of the round (its ``train.<phase>``
    ranges: schedule, local_training, deltas, server, bookkeeping) the
    host time spent in the range and the device kernel time it launched.

Prints one JSON object of means per round. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

PHASE_PREFIX = "train."


def _kind(name: str) -> str:
    n = name.lower()
    if "fedavg_kernel" in n or "robust_kernel" in n or "sq_norms" in n:
        return "delta_pipeline (K2-K4)"
    if any(k in n for k in ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")):
        return "gemm"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--top", type=int, default=12)
    args, rest = ap.parse_known_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train

    run = train.Run(train.parse_args(["--scale", "full", "--pallas-agg"] + rest))
    state, r = run.state, 0
    run.state = None

    def one():
        nonlocal state, r
        slot_ids, batch = run.batch(r)
        state, _ = run.round_fn(state, batch)
        run.step_telemetry(r, slot_ids)
        r += 1

    one()
    wall = []
    for _ in range(args.rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.rounds):
            one()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / args.rounds * 1e3
    n = args.rounds
    kernels: dict[str, list[float]] = {}
    phases: dict[str, dict[str, float]] = {}
    for e in prof.events():
        if e.name.startswith(PHASE_PREFIX):
            ph = phases.setdefault(e.name[len(PHASE_PREFIX):], {})
            if e.device_type == DeviceType.CUDA:
                continue
            for k, us in (("host_ms", e.cpu_time_total), ("kernel_ms", e.device_time_total)):
                ph[k] = ph.get(k, 0.0) + us / 1e3 / n
        elif e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            kernels.setdefault(e.name, []).append(e.device_time_total / 1e3)
    measured = bool(kernels)
    device_ms = sum(sum(v) for v in kernels.values()) / n
    kinds: dict[str, float] = {}
    for k, v in kernels.items():
        kinds[_kind(k)] = kinds.get(_kind(k), 0.0) + sum(v) / n
    ranked = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:args.top]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "arch": run.cfg.name, "params": run.model.param_count(),
        "slots": run.fl_cfg.slots, "local_steps": run.fl_cfg.local_steps,
        "fog_nodes": run.fl_cfg.fog_nodes, "population": run.fl_cfg.population,
        "wall_ms_per_round": wall,
        "profiled_wall_ms_per_round": prof_ms,
        "device_kernel_ms_per_round": device_ms if measured else "not measured",
        "device_busy_share": device_ms / prof_ms if measured else "not measured",
        "kernel_launches_per_round": sum(len(v) for v in kernels.values()) / n,
        "device_ms_by_kind": kinds or "not measured",
        "phases_per_round": phases or "not measured",
        "top_kernels": [{"name": k[:90], "ms_per_round": sum(v) / n,
                         "calls_per_round": len(v) / n} for k, v in ranked],
        "peak_bytes": torch.cuda.max_memory_allocated(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
