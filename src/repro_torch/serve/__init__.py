"""Continuous-batching serving engine over the paged decode state (port
of ``repro/serve``).

    arrivals.py  — Poisson/diurnal request traces as KIND_ARRIVE events.
    scheduler.py — host control plane: slot scheduler + page allocator.
    paged.py     — device state and programs: paged KV pool, admission
                   (prefill with K5 -> page scatter), the one batched
                   decode step (dense gather or K7); for rwkv6 the
                   slot-indexed recurrent state, admission through K6
                   and the plain one-token recurrence.
    costs.py     — §IV.F virtual latency/energy on ``RoundCostModel``.
    engine.py    — ``ContinuousBatchingEngine``.
    oracle.py    — ``SequentialOracle``, the per-request reference.
    sweep.py     — ``sweep_rates``: arrival-rate grids over one engine.
"""
from repro_torch.serve.arrivals import RequestTrace, TraceConfig, make_trace, trace_from_arrays
from repro_torch.serve.costs import ServeCostModel
from repro_torch.serve.engine import ContinuousBatchingEngine, EngineConfig, ServeReport
from repro_torch.serve.oracle import SequentialOracle
from repro_torch.serve.paged import PagePlan
from repro_torch.serve.scheduler import PageAllocator, SlotScheduler
from repro_torch.serve.sweep import SweepServeResult, sweep_rates

__all__ = [
    "ContinuousBatchingEngine", "EngineConfig", "PageAllocator", "PagePlan",
    "RequestTrace", "SequentialOracle", "ServeCostModel", "ServeReport",
    "SlotScheduler", "SweepServeResult", "TraceConfig", "make_trace", "sweep_rates",
    "trace_from_arrays",
]
