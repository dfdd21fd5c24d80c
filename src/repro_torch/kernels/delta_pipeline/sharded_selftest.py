"""Selftest of the sharded delta pipeline on a world of ranks (port of
``repro/kernels/delta_pipeline/sharded_selftest.py``).

    python -m repro_torch.kernels.delta_pipeline.sharded_selftest \\
        [--devices 8] [--zero 2] [--device cpu|cuda] [--backend gloo|nccl] --json

Spawns ``--devices`` ranks (client × zero, ``dist.world``) and sweeps the
JAX package's gate matrix, comparing on identical inputs (numpy, seed 0)

    delta_pipeline_apply_sharded  (each rank: K4 on its rows + 1 all-reduce)
    delta_pipeline_apply          (one rank, every row: K3)
    delta_pipeline_ref            (the plain version)

on the CUDA card unless ``--device cpu``, and reads each rank's
``dist.CollectiveLog``: exactly ONE all-reduce
crossing the client axis carries the (P+2,) pack, which the launcher's
guard ``dist.assert_inter_client_contract`` accepts. Prints one JSON line
(with ``--json``); exits 0 when every case holds. On the CPU the kernels
are their plain versions, so the middle leg equals the last.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def gate_matrix():
    """(name, kwargs) cases: every kernel gate alone plus the full stack."""
    seg = (1024, 512, 512)  # sums to P=2048
    return [
        ("plain", {}),
        ("clip", dict(clip_norm=0.5)),
        ("int8", dict(compression="int8", seg_sizes=seg)),
        ("topk", dict(compression="topk", topk_fraction=0.1, seg_sizes=seg)),
        ("staleness", dict(staleness=True, staleness_exponent=0.5)),
        ("dp", dict(dp=True)),
        ("fedavgm", dict(momentum=True, server_optimizer="fedavgm")),
        ("fedadam", dict(momentum=True, server_optimizer="fedadam")),
        ("full", dict(clip_norm=0.5, compression="int8", seg_sizes=seg,
                      dp=True, momentum=True, server_optimizer="fedavgm")),
    ]


def tolerance(static: dict) -> float:
    """fedadam divides by (|agg| + 1e-3): where the aggregate crosses zero
    that amplifies the reduction's reassociation error (~2e-7) by up to
    1e3 (the JAX selftest's reasoning and numbers)."""
    return 5e-3 if static.get("server_optimizer") == "fedadam" else 1e-5


def make_inputs(c: int = 16, p: int = 2048, seed: int = 0) -> dict:
    """The JAX selftest's inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return dict(
        upd=rng.normal(size=(c, p)).astype(np.float32),
        base=rng.normal(size=(p,)).astype(np.float32),
        mask=rng.random(c) < 0.75,
        weights=rng.integers(10, 100, c).astype(np.float32),
        stale=rng.integers(0, 4, c).astype(np.float32),
        noise=(rng.normal(size=(p,)) * 1e-3).astype(np.float32),
        mu=(rng.normal(size=(p,)) * 0.1).astype(np.float32),
    )


def case_args(x: dict, case: dict):
    """(positional arguments, static keywords) of one gate case on the
    tensors ``x`` (keys of :func:`make_inputs`)."""
    case = dict(case)
    args = (x["upd"], x["base"], x["mask"], x["weights"], 0.7,
            x["stale"] if case.pop("staleness", False) else None,
            case.pop("staleness_exponent", 0.0),
            x["noise"] if case.pop("dp", False) else None,
            x["mu"] if case.pop("momentum", False) else None)
    return args, case


def rank_cases(ctx, axis_sizes: tuple[int, ...], fog_nodes: int = 1,
               flat_too: bool = False, c: int = 16, p: int = 2048) -> dict:
    """One rank's sweep of the gate matrix: ``axis_sizes`` is (client,
    zero) or (pod, client, zero); with ``fog_nodes`` the pod axis is the
    fog tier. Returns per case the sharded outputs (numpy), the
    single-rank K3 / fog outputs and plain outputs on all rows, the
    all-reduces of the rank's ledger by tier and whether the contract
    guard accepts it; ``flat_too`` adds the flat (``fog_nodes=1``) run on
    the same mesh as case ``"flat"``."""
    import torch

    from repro_torch.dist import (
        CollectiveLog,
        ShardingRules,
        assert_inter_client_contract,
        count_axis_crossing,
    )
    from repro_torch.dist.meshes import MeshPlan
    from repro_torch.fl.fog import fog_pipeline_apply
    from repro_torch.kernels.delta_pipeline import ops, ref
    from repro_torch.kernels.delta_pipeline.sharded import (
        delta_pipeline_apply_sharded,
        split_fog_axes,
    )

    pods = axis_sizes[0] if len(axis_sizes) == 3 else 1
    plan = MeshPlan(num_pods=pods, num_clients=pods * axis_sizes[-2], zero=axis_sizes[-1],
                    model_axes=("tp", "sp"), model_split=(1, 1))
    mesh = plan.build_mesh(ctx.backend, ctx.device)
    rules = ShardingRules(cfg=None, plan=plan, mesh=mesh)
    client_axes = plan.client_axes
    ways = mesh.ways(client_axes)
    per = c // ways
    lo = mesh.index(client_axes) * per
    x = {k: torch.from_numpy(v).to(ctx.device) for k, v in make_inputs(c, p).items()}

    def rows(t):
        """A (C,) row argument cut to this rank's clients."""
        return t[lo:lo + per] if isinstance(t, torch.Tensor) and t.shape == (c,) else t

    def arrays(o):
        return [t.cpu().numpy() for t in (o if isinstance(o, tuple) else (o,))]

    cases = [(n, case, fog_nodes) for n, case in gate_matrix()]
    if flat_too:
        cases.append(("flat", {}, 1))
    out = {}
    for name, case, fog in cases:
        args, static = case_args(x, case)
        local = (args[0][lo:lo + per].contiguous(),) + tuple(rows(a) for a in args[1:])
        with CollectiveLog() as log:
            sh = delta_pipeline_apply_sharded(*local, mesh=mesh, client_axes=client_axes,
                                              fog_nodes=fog, **static)
        single = (fog_pipeline_apply(*args, fog_nodes=fog, **static) if fog > 1
                  else ops.delta_pipeline_apply(*args, **static))
        min_b = 2.0 * p  # half the pack's 4·(P+2) bytes
        fog_axes, edge_axes = (split_fog_axes(mesh, client_axes, fog) if fog > 1
                               else (client_axes, ()))
        try:
            assert_inter_client_contract(log, rules, p, fog_nodes=fog)
            contract_ok = True
        except AssertionError:
            contract_ok = False
        out[name] = dict(
            sharded=arrays(sh), single=arrays(single),
            plain=arrays(ref.delta_pipeline_ref(*args, **static)),
            static=static,
            client_all_reduces=count_axis_crossing(log, mesh, axes=client_axes,
                                                   min_bytes=min_b),
            fog_all_reduces=count_axis_crossing(log, mesh, axes=fog_axes, min_bytes=min_b,
                                                not_axes=edge_axes),
            edge_all_reduces=(count_axis_crossing(log, mesh, axes=edge_axes,
                                                  min_bytes=min_b, not_axes=fog_axes)
                              if edge_axes else 0),
            pack_bytes=[op.bytes for op in log.ops],
            contract_ok=contract_ok,
        )
    return out


def max_diff(a, b) -> float:
    return max(float(np.max(np.abs(x.astype(np.float64) - y.astype(np.float64))))
               for x, y in zip(a, b))


def summarize(per_rank: list, *, fog: bool = False, edge_ways: int = 1) -> dict:
    """Hold every rank's cases: sharded == single == plain within
    :func:`tolerance`, every rank's outputs equal (replicated epilogue),
    and the all-reduces per tier (flat: one crossing the client axes; fog:
    one confined to the edge axes unless they span one rank, one across
    the fog axis, two crossing the union)."""
    res, ok = {}, True
    for name, case in per_rank[0].items():
        tol = tolerance(case["static"])
        d_single = max_diff(case["sharded"], case["single"])
        d_plain = max_diff(case["sharded"], case["plain"])
        replicated = all(max_diff(r[name]["sharded"], case["sharded"]) == 0.0
                         for r in per_rank)
        if fog and name != "flat":
            want = dict(edge_all_reduces=1 if edge_ways > 1 else 0, fog_all_reduces=1,
                        client_all_reduces=2 if edge_ways > 1 else 1)
        else:
            want = dict(client_all_reduces=1)
        counts_ok = all(r[name][k] == v for r in per_rank for k, v in want.items())
        contract_ok = all(r[name]["contract_ok"] for r in per_rank)
        case_ok = bool(d_single < tol and d_plain < tol and replicated and counts_ok
                       and contract_ok)
        res[name] = dict(max_diff_vs_single=d_single, max_diff_vs_plain=d_plain,
                         replicated=replicated, tol=tol, contract_ok=contract_ok, ok=case_ok,
                         **{k: case[k] for k in ("client_all_reduces", "fog_all_reduces",
                                                 "edge_all_reduces", "pack_bytes")})
        ok = ok and case_ok
    return dict(cases=res, ok=ok)


def run_selftest(devices: int = 8, *, zero: int = 2, device=None,
                 backend: str = "gloo") -> dict:
    from repro_torch.device import resolve_device
    from repro_torch.dist.world import spawn

    device = resolve_device(device)
    client_ways = devices // zero
    per_rank = spawn(rank_cases, devices, (client_ways, zero), backend=backend,
                     device=device)
    return dict(devices=devices, client_ways=client_ways, zero=zero, device=str(device),
                backend=backend, **summarize(per_rank))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--zero", type=int, default=2)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="default: the CUDA card; 'cpu' to ask for the CPU")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    res = run_selftest(args.devices, zero=args.zero, device=args.device,
                       backend=args.backend)
    if args.json:
        print(json.dumps(res))
    else:
        for k, v in res.items():
            print(f"{k}: {v}")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
