"""Where one round of the port's main path spends its time on the card.

    PYTHONPATH=src python3 -m repro_torch.tools.profile_round [--rounds 10]
        [--population M] [--fog-nodes F]
        [--engine async --async cohort|fedasync|fedbuff]

Builds ``FedFogSimulator(SimulatorConfig(use_pallas_agg=True))`` on CUDA
at the default (64-client, 112,766-parameter) configuration, or with a
population of M virtual clients sampled down to that cohort and F fog
aggregators, runs two warm-up rounds, then measures passes of
``--rounds`` rounds:

  * three unprofiled passes: the host clock around each pass, ending in a
    synchronise (three, so the host's spread within one call shows);
  * one pass under ``torch.profiler``: device kernel time per round, the
    device's busy share (kernel time over the profiled wall time), kernel
    launches per round, the kernels that take the most device time, and,
    per phase of ``_round`` (its ``round.<phase>`` ranges: schedule,
    local_sgd, costs, server — the fused delta pipeline —, telemetry,
    eval), the host time spent in the range and the device kernel time it
    launched.

Also reports what one phase guard of ``_round`` costs the host with no
profiler running (it then opens no range; six guards run per round).
Prints one JSON object of means per round. Needs a CUDA device.

With ``--engine async`` it profiles the event engine instead
(``sim.events.AsyncFedFogSimulator``, coalesced loop) at the same
configuration, with ``--rounds`` dispatches a run under ``cohort``
(``AsyncConfig()``), ``fedasync`` (``AsyncConfig.fedasync(
straggler_sigma=0.5)``) or ``fedbuff`` (``AsyncConfig.fedbuff(8)``): a
warm-up run of two dispatches, three unprofiled runs (wall ms per
dispatch and per flush, host clock around the event loop, ending in a
synchronise), one run under ``torch.profiler`` (launches, kernel ms and
the busy share, per dispatch and per flush, K3 / K4 ms) and one under
``torch.cuda.set_sync_debug_mode`` (host synchronisations per coalesced
step and per flush).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

PHASE_PREFIX = "round."


def _wall_ms(sim, state, rounds):
    t0 = time.perf_counter()
    for r in rounds:
        state = sim._round(sim.env, *state, r, in_place=True)[:3]
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) / len(rounds) * 1e3


def _kernel_profile(sim, state, rounds, top):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, wall_ms = _wall_ms(sim, state, rounds)
    n = len(rounds)
    kernels: dict[str, list[float]] = {}
    phases: dict[str, dict[str, float]] = {}
    for e in prof.events():
        if e.name.startswith(PHASE_PREFIX):
            ph = phases.setdefault(e.name[len(PHASE_PREFIX):], {})
            if e.device_type == DeviceType.CUDA:  # the range as seen on the device
                parts = {"device_span_ms": e.device_time_total}
            else:
                parts = {"host_ms": e.cpu_time_total, "kernel_ms": e.device_time_total}
            for k, us in parts.items():
                ph[k] = ph.get(k, 0.0) + us / 1e3 / n
        elif e.device_type == DeviceType.CUDA and e.device_time_total > 0:
            kernels.setdefault(e.name, []).append(e.device_time_total / 1e3)
    device_ms = sum(sum(v) for v in kernels.values()) / n
    ranked = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:top]
    # K3 and K4 are the two instantiations of fedavg_kernel.
    k3 = sum(sum(v) for k, v in kernels.items() if "fedavg_kernel" in k) / n
    measured = bool(kernels)
    return state, {
        "profiled_wall_ms_per_round": wall_ms,
        "device_kernel_ms_per_round": device_ms if measured else "not measured",
        "device_busy_share": device_ms / wall_ms if measured else "not measured",
        "kernel_launches_per_round": sum(len(v) for v in kernels.values()) / n,
        "delta_pipeline_kernel_ms_per_round": k3 if measured else "not measured",
        "phases_per_round": phases or "not measured",
        "top_kernels": [
            {"name": k[:90], "ms_per_round": sum(v) / n, "calls_per_round": len(v) / n}
            for k, v in ranked
        ],
    }


def _profile_events(fn):
    """(wall ms, {kernel: [device ms]}) of ``fn()`` under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.device_time_total > 0 \
                and not e.name.startswith(PHASE_PREFIX):
            kernels.setdefault(e.name, []).append(e.device_time_total / 1e3)
    return wall_ms, kernels


def count_syncs(fn) -> int:
    """Synchronising CUDA calls made by ``fn()``, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


ASYNC_MODES = ("cohort", "fedasync", "fedbuff")


def _async_config(mode):
    from repro_torch.sim.events import AsyncConfig

    return {"cohort": AsyncConfig, "fedasync": lambda: AsyncConfig.fedasync(
        straggler_sigma=0.5), "fedbuff": lambda: AsyncConfig.fedbuff(8)}[mode]()


def profile_async(mode: str, dispatches: int, population, fog_nodes, top: int) -> dict:
    """The event engine's profile (module docstring), as a dict."""
    from repro_torch.fl.simulator import SimulatorConfig
    from repro_torch.sim.events import AsyncFedFogSimulator

    def engine(n):
        cfg = SimulatorConfig(rounds=n, use_pallas_agg=True, population=population,
                              fog_nodes=fog_nodes)
        return AsyncFedFogSimulator(cfg, _async_config(mode), device="cuda")

    def one_run(sim):
        state = sim.init_state(sim.cfg.seed)
        torch.cuda.synchronize()
        out = {}
        t0 = time.perf_counter()
        out["final"] = sim._scan_events(state)
        torch.cuda.synchronize()
        out["wall_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    engine(2).run()  # warm-up
    sim = engine(dispatches)
    runs = [one_run(sim) for _ in range(3)]
    n_d, n_f = runs[0]["final"].dispatch_idx, runs[0]["final"].flush_idx
    state = sim.init_state(sim.cfg.seed)
    torch.cuda.synchronize()
    wall_ms, kernels = _profile_events(lambda: sim._scan_events(state))
    steps = sim.steps
    state = sim.init_state(sim.cfg.seed)
    torch.cuda.synchronize()
    syncs = count_syncs(lambda: sim._scan_events(state))
    measured = bool(kernels)
    device_ms = sum(sum(v) for v in kernels.values())
    k34 = sum(sum(v) for k, v in kernels.items() if "fedavg_kernel" in k
              or "robust_kernel" in k)
    launches = sum(len(v) for v in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:top]
    return {
        "engine": "async", "async": mode, "dispatches": n_d, "flushes": n_f,
        "coalesced_steps": steps,
        "wall_ms_per_dispatch_by_pass": [r["wall_ms"] / n_d for r in runs],
        "wall_ms_per_flush_by_pass": [r["wall_ms"] / n_f for r in runs],
        "profiled_wall_ms": wall_ms,
        "kernel_launches_per_dispatch": launches / n_d,
        "kernel_launches_per_flush": launches / n_f,
        "device_kernel_ms_per_dispatch": device_ms / n_d if measured else "not measured",
        "device_busy_share": device_ms / wall_ms if measured else "not measured",
        "delta_pipeline_kernel_ms_per_flush": k34 / n_f if measured else "not measured",
        "host_syncs_per_step": syncs / steps,
        "host_syncs_per_flush": syncs / n_f,
        "host_syncs": syncs,
        "top_kernels": [
            {"name": k[:90], "ms_per_dispatch": sum(v) / n_d, "calls": len(v)}
            for k, v in ranked
        ],
    }


def _phase_guard_us(n=10_000):
    from repro_torch.fl.simulator import _phase

    t0 = time.perf_counter()
    for _ in range(n):
        with _phase("empty"):
            pass
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--population", type=int, default=None)
    ap.add_argument("--fog-nodes", type=int, default=1)
    ap.add_argument("--engine", choices=("scan", "async"), default="scan")
    ap.add_argument("--async", dest="async_mode", choices=ASYNC_MODES, default="fedbuff")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_round: needs a CUDA device")
    if args.engine == "async":
        # The first sync-debug window of a process reports a synchronisation
        # that no later one does: open it on a single copy first.
        count_syncs(lambda: torch.zeros(1, device="cuda").cpu())
        prof = profile_async(args.async_mode, args.rounds, args.population,
                             args.fog_nodes, args.top)
        print(json.dumps({
            "device": torch.cuda.get_device_name(0),
            "population": args.population, "fog_nodes": args.fog_nodes,
            "peak_bytes": torch.cuda.max_memory_allocated(), **prof,
        }))
        return 0

    from repro_torch.fl.simulator import FedFogSimulator, SimulatorConfig

    n = args.rounds
    sim = FedFogSimulator(
        SimulatorConfig(rounds=2 + 4 * n, use_pallas_agg=True,
                        population=args.population, fog_nodes=args.fog_nodes),
        device="cuda",
    )
    state = (sim.params, sim.sched_state, sim.telemetry)
    state, _ = _wall_ms(sim, state, range(2))  # warm-up
    wall_ms = []
    for i in range(3):
        state, ms = _wall_ms(sim, state, range(2 + i * n, 2 + (i + 1) * n))
        wall_ms.append(ms)
    state, prof = _kernel_profile(sim, state, range(2 + 3 * n, 2 + 4 * n), args.top)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "rounds": n,
        "population": sim.population,
        "fog_nodes": args.fog_nodes,
        "wall_ms_per_round_by_pass": wall_ms,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "phase_guard_us_unprofiled": _phase_guard_us(),
        **prof,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
