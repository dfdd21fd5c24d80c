"""Arrival-rate sweeps over the serving engine (port of
``repro/serve/sweep.py``).

The swept quantity (offered load) is trace DATA, never program
structure, so one ``ContinuousBatchingEngine`` serves the whole grid. The
JAX package asserts that its engine compiled nothing new; eager PyTorch
compiles nothing, so the port holds what it has instead: the engine's
admission and decode programs and its page count are the same objects
after the grid as before it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

from repro_torch.random import TorchDraws
from repro_torch.serve.arrivals import TraceConfig, make_trace
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeReport


@dataclasses.dataclass(frozen=True)
class SweepServeResult:
    rates_per_s: np.ndarray  # (G,)
    reports: list[ServeReport]

    def column(self, name: str) -> np.ndarray:
        """(G,) array of one scalar report field (e.g. 'goodput_rps')."""
        vals = []
        for rep in self.reports:
            v = getattr(rep, name)
            vals.append(v["p95"] if name == "percentiles" else v)
        return np.asarray(vals, np.float64)


def sweep_rates(engine: ContinuousBatchingEngine, trace_cfg: TraceConfig, rates_per_s,
                seed: int = 0,
                draws: Callable[[int], Any] | None = None) -> SweepServeResult:
    """Serve one trace per offered load, point g's trace drawn from the
    provider ``draws(seed + g)`` (default: ``TorchDraws`` on the CPU,
    where ``make_trace`` reads its draws)."""
    draws = draws or (lambda s: TorchDraws(s, "cpu"))
    before = (engine._admit, engine._decode, engine.num_pages)
    reports = []
    for g, rate in enumerate(rates_per_s):
        cfg = dataclasses.replace(trace_cfg, rate_per_s=float(rate))
        trace = make_trace(draws(seed + g), cfg, engine.model.cfg)
        reports.append(engine.serve(trace))
    after = (engine._admit, engine._decode, engine.num_pages)
    assert all(a is b for a, b in zip(before[:2], after[:2])) and before[2] == after[2], (
        "arrival-rate sweep rebuilt the engine's programs"
    )
    return SweepServeResult(rates_per_s=np.asarray(list(rates_per_s), np.float64),
                            reports=reports)
