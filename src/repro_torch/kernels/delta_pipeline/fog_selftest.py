"""Selftest of the FOG-TIER sharded delta pipeline on a world of ranks
(port of ``repro/kernels/delta_pipeline/fog_selftest.py``).

    python -m repro_torch.kernels.delta_pipeline.fog_selftest \\
        [--devices 8] [--pods 2] [--zero 2] [--device cpu|cuda] --json

Spawns ``--devices`` ranks as pod × client × zero (on the CUDA card
unless ``--device cpu``) and runs the gate
matrix through ``delta_pipeline_apply_sharded`` with ``fog_nodes`` equal
to the pod count, so the round reduces edge → fog → cloud: one packed
all-reduce confined to the edge (client) axis within each pod, then one
across the fog (pod) axis. Each case is held against the single-rank fog
kernel path (``fl.fog.fog_pipeline_apply``, one K4 per fog) and the plain
version, and each rank's ``dist.CollectiveLog`` two ways:

  * ``count_axis_crossing`` per tier: ONE all-reduce of the pack confined
    to the edge axis and ONE crossing the fog axis;
  * ``dist.assert_inter_client_contract(..., fog_nodes=F)``, the guard the
    launcher applies each round;

then the flat combine (``fog_nodes=1``) on the same ranks keeps its one
all-reduce crossing the union. Prints one JSON line with ``--json``.
"""
from __future__ import annotations

import argparse
import json


def run_selftest(devices: int = 8, *, pods: int = 2, zero: int = 2, device=None,
                 backend: str = "gloo") -> dict:
    from repro_torch.device import resolve_device
    from repro_torch.dist.world import spawn
    from repro_torch.kernels.delta_pipeline.sharded_selftest import rank_cases, summarize

    device = resolve_device(device)
    edge_ways = devices // (pods * zero)
    # the fog cases, then the flat combine on the same ranks
    per_rank = spawn(rank_cases, devices, (pods, edge_ways, zero), pods, True,
                     backend=backend, device=device)
    return dict(devices=devices, pods=pods, edge_ways=edge_ways, zero=zero,
                fog_nodes=pods, device=str(device), backend=backend,
                **summarize(per_rank, fog=True, edge_ways=edge_ways))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--zero", type=int, default=2)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="default: the CUDA card; 'cpu' to ask for the CPU")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    res = run_selftest(args.devices, pods=args.pods, zero=args.zero, device=args.device,
                       backend=args.backend)
    if args.json:
        print(json.dumps(res))
    else:
        for k, v in res.items():
            print(f"{k}: {v}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
