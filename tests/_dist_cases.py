"""Rank-side pieces of the port's distributed CPU tests.

The ranks of a ``repro_torch.dist.world.World`` import this module (by
name, from the tests directory on their path) and never JAX: the JAX
side runs in the test process. ``Recording`` wraps a draw provider (the
test's ``JaxDraws``) around the single-process port round and keeps every
draw it hands out; ``Replay`` hands the same blocks, in the same order,
to the sharded round on each rank, whose replicated island asks for the
same draws in the same order.
"""
import torch


class Recording:
    """A draw provider that passes calls to ``inner`` and keeps
    ``(method, site, round, result)`` of each."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if not callable(attr):
            return attr

        def record(*args, **kwargs):
            out = attr(*args, **kwargs)
            self.calls.append((name, args[0] if args else None, kwargs.get("round"), out))
            return out

        return record


class Replay:
    """A draw provider that returns recorded blocks in order, checking that
    each call asks for the recorded method, site and round."""

    def __init__(self, calls, device="cpu"):
        self.calls = list(calls)
        self.device = torch.device(device)
        self.i = 0

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def replay(*args, **kwargs):
            method, site, rnd, out = self.calls[self.i]
            got = (name, args[0] if args else None, kwargs.get("round"))
            assert got == (method, site, rnd), (self.i, got, (method, site, rnd))
            self.i += 1
            return out.clone() if isinstance(out, torch.Tensor) else out

        return replay


def rank_round(ctx, spec: dict) -> dict:
    """The sharded LM round on this rank over ``spec["batches"]`` (numpy),
    from ``spec["state"]`` (the port's FLState), with the recorded draws;
    each round's contract asserted on the rank's ledger. Returns the final
    state, the metrics of each round as host numbers and the ledger's
    counts."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.scheduler import SchedulerConfig
    from repro_torch.dist import (
        CollectiveLog,
        assert_inter_client_contract,
        count_axis_crossing,
        make_rules,
    )
    from repro_torch.fl import FLConfig, make_round_fn
    from repro_torch.launch.train import host_metrics
    from repro_torch.models import build_model
    from repro_torch.sim.faults import FaultConfig

    cfg = get_reduced("llama3.2-1b", param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg)
    over = dict(spec["fl"])
    if "faults" in over:
        over["faults"] = FaultConfig(**over["faults"])
    fl = FLConfig(scheduler=SchedulerConfig(theta_d=0.5), **over)
    rules = make_rules(None, cfg, multi_pod=fl.fog_nodes > 1, device_count=ctx.world_size,
                       zero=spec.get("zero"), backend=ctx.backend, device=ctx.device)
    fn = make_round_fn(model, fl, flops_per_client_round=1e9, rules=rules,
                       draws=Replay(spec["calls"]))
    p = model.param_count()
    mesh, client_axes = rules.mesh, rules.plan.client_axes
    state, metrics, contract, zero_ops, zero_crossing_clients = spec["state"], [], [], [], []
    for b in spec["batches"]:
        batch = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
        with CollectiveLog() as log, torch.no_grad():
            state, m = fn(state, batch)
        contract.append(assert_inter_client_contract(log, rules, p, fl.fog_nodes)[0])
        big = dict(kinds=("all-reduce",), min_bytes=2.0 * p)
        zero_ops.append(count_axis_crossing(log, mesh, axes=("zero",), not_axes=client_axes,
                                            **big))
        zero_crossing_clients.append(
            count_axis_crossing(log, mesh, axes=("zero",), **big) - zero_ops[-1])
        metrics.append(host_metrics(m))
    return dict(state=state, metrics=metrics, contract=contract, zero_ops=zero_ops,
                zero_crossing_clients=zero_crossing_clients,
                slots=rules.slot_range(fl.slots), zero=rules.zero_ways)
