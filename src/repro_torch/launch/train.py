"""Federated training launcher (port of ``repro/launch/train.py``), on the
CUDA card unless ``--device cpu``: configs → model → FedFog round →
synthetic token data → checkpointing, with auto-resume.

    python -m repro_torch.launch.train --arch llama3.2-1b --rounds 100 \
        --scale tiny --device cpu --ckpt-dir /tmp/fedfog_ckpt
    python -m repro_torch.launch.train --arch llama3.2-1b --scale full \
        --rounds 3 --pallas-agg [--fog-nodes 2 --population 1000000]

``--scale tiny`` runs the reduced config (``get_reduced(arch,
loss_chunk=0)``); ``--scale full`` the assigned config on one card, the
JAX package's single-host round; it needs a card. ``--pallas-agg`` runs
the server side through the delta-pipeline kernels: K3 once a round, or
K4 per fog with ``--fog-nodes``; K2 with a clip norm. The mesh flags of
the JAX launcher (``--devices``, ``--multi-pod``, ``--reduced``,
``--compile-only``) belong to the distributed path and raise until
ROADMAP.md queue 1, item 11 ports it.

Draws come from one ``TorchDraws(--seed)``: the state's parameters from
the seed's key, the round's draws keyed by its index, the data
(``data.synthetic``) keyed by the round and the slot occupants. Each
round's metrics reach the host in ONE copy, for the printed line and the
tracker.
"""
from __future__ import annotations

import argparse
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
                    help="the mesh's device count (distributed path: raises)")
    ap.add_argument("--multi-pod", action="store_true")
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
                    help="reduced config on the mesh plan (distributed path: raises)")
    ap.add_argument("--compile-only", action="store_true",
                    help="compile the sharded round only (distributed path: raises)")
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


class Run:
    """Everything ``main`` builds before its loop: the model, the round,
    the state (restored when resuming), the data and telemetry sources."""

    def __init__(self, args):
        if args.devices or args.multi_pod or args.reduced or args.compile_only:
            raise NotImplementedError(
                "--devices, --multi-pod, --reduced and --compile-only drive the "
                "distributed mesh path, not ported yet: ROADMAP.md queue 1, item 11")
        from repro_torch import checkpoint as ckpt
        from repro_torch.configs import get_config, get_reduced
        from repro_torch.data.synthetic import FedDataConfig, client_data_sizes
        from repro_torch.data.telemetry import (TelemetryConfig, init_telemetry,
                                                make_profiles)
        from repro_torch.device import resolve_device
        from repro_torch.fl import FLConfig, init_fl_state, make_round_fn
        from repro_torch.models import build_model
        from repro_torch.random import TorchDraws

        full = args.scale == "full"
        self.device = resolve_device(args.device)
        if full and self.device.type != "cuda":
            raise ValueError("--scale full runs on the CUDA card only")
        self.args = args
        self.cfg = get_config(args.arch) if full else get_reduced(args.arch, loss_chunk=0)
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
            draws=self.draws,
        )
        self.state = init_fl_state(self.model, self.fl_cfg, args.seed, device=self.device)
        self.start_round = 0
        self.checkpointer = None
        if args.ckpt_dir:
            self.checkpointer = ckpt.AsyncCheckpointer(args.ckpt_dir)
            latest = ckpt.latest_step(args.ckpt_dir) if args.resume else None
            if latest is not None:
                self.state = ckpt.restore(args.ckpt_dir, latest, self.state)
                self.start_round = latest
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


def host_metrics(metrics) -> dict:
    """The round's 0-d metric tensors as host numbers, in ONE copy."""
    import torch

    vals = torch.stack([v.to(torch.float64) for v in metrics.values()]).tolist()
    return {k: (v if metrics[k].is_floating_point() else int(v))
            for k, v in zip(metrics, vals)}


def main(argv=None):
    from repro_torch.obs import tracker_from_spec

    args = parse_args(argv)
    run = Run(args)
    tracker = tracker_from_spec(args.track)
    with tracker:
        return _train_loop(run, tracker)


def _train_loop(run: Run, tracker):
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
        print(
            f"[round {r:4d}] loss={m['loss']:.4f} selected={m['num_selected']} "
            f"cold={m['cold_starts']} latency={m['round_latency_ms']:.0f}ms "
            f"energy={m['energy_j']:.1f}J "
            + (f"retries={m['fault_retries']} lost={m['fault_lost']} "
               f"skipped={m['round_skipped']} " if fl_cfg.faults is not None else "")
            + f"({time.time() - t0:.2f}s)",
            flush=True,
        )
        if run.checkpointer and (r + 1) % args.ckpt_every == 0:
            run.checkpointer.save(r + 1, state)
    if run.checkpointer:
        run.checkpointer.wait()
    tracker.log_summary({"arch": args.arch, "scale": args.scale,
                         "rounds": args.rounds - run.start_round,
                         "final_loss": m.get("loss", 0.0)})
    run.state = state
    return state


if __name__ == "__main__":
    main()
