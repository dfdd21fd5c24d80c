"""Federated training launcher (port of ``repro/launch/train.py``), on the
CUDA card unless ``--device cpu``: configs → model → FedFog round →
synthetic token data → checkpointing, with auto-resume.

    python -m repro_torch.launch.train --arch llama3.2-1b --rounds 100 \
        --scale tiny --device cpu --ckpt-dir /tmp/fedfog_ckpt
    python -m repro_torch.launch.train --arch llama3.2-1b --scale full \
        --rounds 3 --pallas-agg [--fog-nodes 2 --population 1000000]

``--scale tiny`` runs the reduced config (``get_reduced(arch,
loss_chunk=0)``); ``--scale full`` the assigned config on one card, the
JAX package's single-host round; it needs a card (``--reduced`` keeps
the reduced config at either scale). ``--pallas-agg`` runs the server
side through the delta-pipeline kernels: K3 once a round, or K4 per fog
with ``--fog-nodes``; K2 with a clip norm.

``--devices N`` runs the client-sharded round on N ranks of one host
(``dist.world``), on the plan of :func:`mesh_plan`: the scaled plan
``plan_for(device_count=N)`` (client × zero, ``--multi-pod``: pod ×
client × zero, the pod axis the fog tier), or at 256 devices (512 with
``--multi-pod``) the production plan with its tensor axes, as the JAX
launcher builds them; it sets the slots to the plan's client count, and
the plan is printed first. A plan with a model split runs the DENSE
family's tensor-parallel round (each rank its parameter blocks;
checkpoints are saved whole, gathered over each model group, and each
rank restores its blocks). Every rank builds the same replicated state and data,
trains its slots and takes part in the round's one packed all-reduce
(asserted on every rank each round from its ``dist.CollectiveLog``);
rank 0 prints, tracks and checkpoints, and ``main`` returns its final
state on the host. ``--backend`` picks the collectives: ``gloo`` (the
default; on CUDA it stages tensors through host memory and lets ranks
share a card) or ``nccl`` (one card per rank, refused otherwise).
``--compile-only`` (the sharded dry run) raises until ROADMAP.md queue
1, item 11(b) ports it.

    python -m repro_torch.launch.train --device cpu --devices 4 --reduced \
        --rounds 2 [--multi-pod --fog-nodes 2] [--pallas-agg]

Draws come from one ``TorchDraws(--seed)``: the state's parameters from
the seed's key, the round's draws keyed by its index, the data
(``data.synthetic``) keyed by the round and the slot occupants. Each
round's metrics reach the host in ONE copy, for the printed line and the
tracker.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--scale", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to ask for the CPU)")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--batch-per-slot", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--inner-lr", type=float, default=0.05)
    ap.add_argument("--track", default="",
                    help="stream per-round metrics to a tracker spec: "
                         "'jsonl:PATH', 'csv:PATH', comma-separated for "
                         "multiple sinks, '' disables (see repro_torch.obs)")
    ap.add_argument("--track-every", type=int, default=1,
                    help="decimation for --track: log every k-th round")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=0,
                    help="run the client-sharded round on N ranks (scaled "
                         "plan: client x zero); 0 = one process")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="collectives of --devices: gloo (CPU, or cards "
                         "shared through host memory) or nccl (a card per rank)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --devices: a leading pod axis of 2 (the fog tier)")
    ap.add_argument("--fog-nodes", type=int, default=1,
                    help="fog-tier width of the edge->fog->cloud reduction")
    ap.add_argument("--population", type=int, default=None,
                    help="virtual client registry size (>= --clients); "
                         "rounds gather a stratified --clients window")
    ap.add_argument("--pallas-agg", action="store_true",
                    help="run the server delta pipeline through the fused "
                         "kernels (K3, or K4 per fog)")
    ap.add_argument("--fault-timeout-rate", type=float, default=0.0,
                    help="cold-start timeout probability (attempt 0)")
    ap.add_argument("--fault-crash-rate", type=float, default=0.0,
                    help="per-attempt function-crash probability")
    ap.add_argument("--fault-drop-rate", type=float, default=0.0,
                    help="per-attempt payload-drop probability")
    ap.add_argument("--fault-corrupt-rate", type=float, default=0.0,
                    help="arrived-payload corruption probability")
    ap.add_argument("--fault-partition-rate", type=float, default=0.0,
                    help="per-round transient network-partition probability")
    ap.add_argument("--fault-fog-outage-rate", type=float, default=0.0,
                    help="per-round per-fog-node outage probability")
    ap.add_argument("--fault-failover", action="store_true",
                    help="reassign a dead fog's clients to survivors")
    ap.add_argument("--fault-retries", type=int, default=0,
                    help="per-client retry cap (exponential backoff)")
    ap.add_argument("--fault-deadline-ms", type=float, default=None,
                    help="server round deadline (None = barrier)")
    ap.add_argument("--fault-quorum", type=float, default=0.0,
                    help="min arrived/admitted fraction to aggregate; "
                         "below quorum the round is skipped")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config at either --scale (on the mesh "
                         "plan with --devices)")
    ap.add_argument("--compile-only", action="store_true",
                    help="the sharded dry run (not ported yet: raises)")
    return ap.parse_args(argv)


def fault_config_from_args(args):
    """The round's ``FaultConfig`` from the ``--fault-*`` flags; None when
    every knob is at its faults-off default."""
    rates = dict(
        timeout_rate=args.fault_timeout_rate,
        crash_rate=args.fault_crash_rate,
        drop_rate=args.fault_drop_rate,
        corrupt_rate=args.fault_corrupt_rate,
        partition_rate=args.fault_partition_rate,
        fog_outage_rate=args.fault_fog_outage_rate,
    )
    if not any(rates.values()) and args.fault_deadline_ms is None:
        return None
    from repro_torch.sim.faults import FaultConfig

    return FaultConfig(
        **rates,
        fog_failover=args.fault_failover,
        max_retries=args.fault_retries,
        deadline_ms=args.fault_deadline_ms,
        quorum_frac=args.fault_quorum,
    )


def mesh_plan(cfg, devices: int, multi_pod: bool = False):
    """The plan of ``--devices`` (JAX ``launch/train.py:164–176``): the
    production plan (``plan_for`` with its 16-way model split) at 256
    devices a pod, 512 with ``multi_pod``; else the scaled host plan,
    client × zero only."""
    from repro_torch.dist.meshes import DATA_PER_POD, MODEL_PER_POD, plan_for

    pods = 2 if multi_pod else 1
    if devices == DATA_PER_POD * MODEL_PER_POD * pods:
        return plan_for(cfg, multi_pod=multi_pod)
    return plan_for(cfg, multi_pod=multi_pod, device_count=devices)


def model_config(args):
    """The assigned config at ``--scale full``, else the reduced one."""
    from repro_torch.configs import get_config, get_reduced

    if args.scale == "full" and not args.reduced:
        return get_config(args.arch)
    return get_reduced(args.arch, loss_chunk=0)


class Run:
    """Everything ``main`` builds before its loop: the model, the round,
    the state (restored when resuming), the data and telemetry sources.
    Under mesh ``rules`` (one rank of ``--devices``) the round is the
    client-sharded one, checked against the collective contract each
    round, on ``device``."""

    def __init__(self, args, rules=None, device=None):
        from repro_torch import checkpoint as ckpt
        from repro_torch.data.synthetic import FedDataConfig, client_data_sizes
        from repro_torch.data.telemetry import (TelemetryConfig, init_telemetry,
                                                make_profiles)
        from repro_torch.device import resolve_device
        from repro_torch.fl import FLConfig, init_fl_state, make_round_fn
        from repro_torch.models import build_model
        from repro_torch.random import TorchDraws

        self.device = resolve_device(args.device if device is None else device)
        if args.scale == "full" and not args.reduced and self.device.type != "cuda":
            raise ValueError("--scale full runs on the CUDA card only")
        from repro_torch.dist.tensor_parallel import TensorParallel

        self.args = args
        self.rank0 = rules is None or rules.mesh.rank == 0
        self.tp = None if rules is None else TensorParallel.from_rules(rules)
        self.cfg = model_config(args)
        self.model = build_model(self.cfg)
        self.fl_cfg = FLConfig(
            num_clients=args.clients,
            slots=args.slots,
            local_steps=args.local_steps,
            inner_lr=args.inner_lr,
            use_pallas_agg=args.pallas_agg,
            fog_nodes=args.fog_nodes,
            population=args.population,
            faults=fault_config_from_args(args),
        )
        self.draws = TorchDraws(args.seed, self.device)
        self.data_cfg = FedDataConfig(vocab_size=self.cfg.vocab_size, drift_period=10,
                                      seed=args.seed)
        self.tel_cfg = TelemetryConfig(num_clients=args.clients, seed=args.seed)
        self.profiles = make_profiles(self.tel_cfg, self.draws)
        self.telemetry = init_telemetry(self.tel_cfg, self.draws)
        self.sizes = client_data_sizes(self.data_cfg, self.draws, args.clients)
        tokens_per_client = args.batch_per_slot * args.seq_len * args.local_steps
        self.round_fn = make_round_fn(
            self.model, self.fl_cfg,
            flops_per_client_round=self.model.flops_per_token() * tokens_per_client,
            rules=rules, draws=self.draws,
        )
        if rules is not None:
            self.round_fn = contract_checked(self.round_fn, rules, self.model.param_count(),
                                             self.fl_cfg.fog_nodes)
        self.state = init_fl_state(self.model, self.fl_cfg, args.seed, device=self.device,
                                   rules=rules)
        self.start_round = 0
        self.checkpointer = None
        if args.ckpt_dir:
            if self.rank0:
                self.checkpointer = ckpt.AsyncCheckpointer(args.ckpt_dir)
            latest = ckpt.latest_step(args.ckpt_dir) if args.resume else None
            if latest is not None:
                self.state = ckpt.restore_rank(args.ckpt_dir, latest, self.state, self.tp)
                self.start_round = latest
                if self.rank0:
                    print(f"[train] resumed from round {latest}")

    def batch(self, r: int):
        """Round ``r``'s batch: the round-robin slot cohort's tokens (the
        round re-ranks the slots itself), the telemetry and histograms."""
        import torch

        from repro_torch.data.synthetic import all_client_histograms, round_batch

        a, fl = self.args, self.fl_cfg
        slot_ids = (torch.arange(fl.slots, device=self.device) + r * fl.slots) % a.clients
        tel = self.telemetry
        return slot_ids, {
            "tokens": round_batch(self.data_cfg, self.draws, slot_ids, r,
                                  a.batch_per_slot * a.local_steps, a.seq_len),
            "slot_data_sizes": self.sizes[slot_ids],
            "telemetry_cpu": tel.cpu,
            "telemetry_mem": tel.mem,
            "telemetry_batt": tel.batt,
            "telemetry_energy": tel.energy,
            "hist": all_client_histograms(self.data_cfg, self.draws, a.clients, r,
                                          fl.hist_bins),
        }

    def step_telemetry(self, r: int, slot_ids) -> None:
        import torch

        from repro_torch.data.telemetry import step_telemetry

        n = self.args.clients
        selected = torch.zeros((n,), dtype=torch.bool, device=self.device)
        selected[slot_ids] = True
        self.telemetry = step_telemetry(
            self.tel_cfg, self.telemetry, selected,
            torch.zeros((n,), dtype=torch.float32, device=self.device),
            self.profiles, self.draws, round=r,
        )


def contract_checked(round_fn, rules, param_count: int, fog_nodes: int):
    """``round_fn`` with each round's collectives logged and held to the
    paper's contract (``dist.assert_inter_client_contract``): one packed
    delta all-reduce across the client ranks, one per tier with a fog
    tier. Raises on a violation."""
    from repro_torch.dist import CollectiveLog, assert_inter_client_contract

    def checked(state, batch):
        with CollectiveLog() as log:
            out = round_fn(state, batch)
        assert_inter_client_contract(log, rules, param_count, fog_nodes)
        return out

    return checked


def host_metrics(metrics) -> dict:
    """The round's 0-d metric tensors as host numbers, in ONE copy."""
    import torch

    vals = torch.stack([v.to(torch.float64) for v in metrics.values()]).tolist()
    return {k: (v if metrics[k].is_floating_point() else int(v))
            for k, v in zip(metrics, vals)}


def main(argv=None):
    from repro_torch.obs import tracker_from_spec

    args = parse_args(argv)
    if args.compile_only:
        raise NotImplementedError(
            "--compile-only is the sharded dry run (launch/dryrun.py, "
            "abstract_fl_state), not ported yet: ROADMAP.md queue 1, item 11(b)")
    if args.devices:
        return main_distributed(args)
    if args.multi_pod:
        raise ValueError("--multi-pod plans a mesh: give --devices N")
    run = Run(args)
    tracker = tracker_from_spec(args.track)
    with tracker:
        return _train_loop(run, tracker)


def main_distributed(args):
    """``--devices N``: the round on N spawned ranks; rank 0's final state,
    on the host. A rank that fails fails the launcher."""
    from repro_torch.device import resolve_device
    from repro_torch.dist.world import spawn

    plan = mesh_plan(model_config(args), args.devices, args.multi_pod)
    args.slots = plan.num_clients
    args.clients = max(args.clients, 2 * args.slots)
    print(f"[train] mesh plan: {plan.shape}", flush=True)
    device = resolve_device(args.device)
    return spawn(_rank_train, args.devices, args, backend=args.backend,
                 device=device, timeout=24 * 3600.0)[0]


def _rank_train(ctx, args):
    """One rank of ``--devices``: its rules, its ``Run`` and the loop; rank
    0 hands back its final state on the host."""
    from repro_torch import tree
    from repro_torch.dist import make_rules
    from repro_torch.fl.state import whole_state
    from repro_torch.obs import NoopTracker, tracker_from_spec

    cfg = model_config(args)
    rules = make_rules(None, cfg, plan=mesh_plan(cfg, ctx.world_size, args.multi_pod),
                       backend=ctx.backend, device=ctx.device)
    run = Run(args, rules=rules, device=ctx.device)
    tracker = tracker_from_spec(args.track) if run.rank0 else NoopTracker()
    with tracker:
        state = _train_loop(run, tracker)
    state = whole_state(state, run.tp)  # every rank of a model group gathers
    if not run.rank0:
        return None
    sched = dataclasses.replace(state.sched, **{
        f.name: getattr(state.sched, f.name).cpu() for f in dataclasses.fields(state.sched)})
    params, mu = tree.map(lambda x: None if x is None else x.cpu(),
                          [state.params, state.server_mu])
    return dataclasses.replace(state, params=params, server_mu=mu, sched=sched,
                               server_count=state.server_count.cpu())


def _train_loop(run: Run, tracker):
    from repro_torch.fl.state import whole_state

    args, fl_cfg = run.args, run.fl_cfg
    # the loop owns the state while it runs: a model-sized state left on
    # ``run`` would stay alive beside every round's
    state, run.state, m = run.state, None, {}
    for r in range(run.start_round, args.rounds):
        t0 = time.time()
        slot_ids, batch = run.batch(r)
        state, metrics = run.round_fn(state, batch)
        m = host_metrics(metrics)
        if r % max(args.track_every, 1) == 0:
            tracker.log({"event": "round", "arch": args.arch, "scale": args.scale, **m,
                         "round_wall_s": time.time() - t0}, step=r)
        run.step_telemetry(r, slot_ids)
        if run.rank0:
            print(
                f"[round {r:4d}] loss={m['loss']:.4f} selected={m['num_selected']} "
                f"cold={m['cold_starts']} latency={m['round_latency_ms']:.0f}ms "
                f"energy={m['energy_j']:.1f}J "
                + (f"retries={m['fault_retries']} lost={m['fault_lost']} "
                   f"skipped={m['round_skipped']} " if fl_cfg.faults is not None else "")
                + f"({time.time() - t0:.2f}s)",
                flush=True,
            )
        if args.ckpt_dir and (r + 1) % args.ckpt_every == 0:
            # whole, gathered over each model group (every rank takes part)
            whole = whole_state(state, run.tp)
            if run.checkpointer:
                run.checkpointer.save(r + 1, whole)
            del whole
    if run.checkpointer:
        run.checkpointer.wait()
    tracker.log_summary({"arch": args.arch, "scale": args.scale,
                         "rounds": args.rounds - run.start_round,
                         "final_loss": m.get("loss", 0.0)})
    run.state = state
    return state


if __name__ == "__main__":
    main()
