"""``repro_torch.serve.sweep.sweep_rates`` on the reduced llama3.2-1b in
float32 on the CPU: every column and every request's tokens equal the
JAX package's ``repro.serve.sweep.sweep_rates`` on the same weights and
the same traces (the JAX package's own draws, through ``JaxDraws``);
every column equals the report of a standalone ``serve`` of the same
point's trace (seed + g) on a fresh engine; the engine's programs and
page count are the same objects after the grid. Also the async engine's
CLI smoke (``sim.events.engine._smoke``) on the CPU."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _jax_draws import JaxDraws
from _threads import one_thread  # noqa: F401 (autouse)
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.serve import ContinuousBatchingEngine as JaxEngine
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import TraceConfig as JaxTraceConfig
from repro.serve.sweep import sweep_rates as jax_sweep_rates
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.random import TorchDraws
from repro_torch.serve import ContinuousBatchingEngine, EngineConfig, TraceConfig, make_trace
from repro_torch.serve.sweep import SweepServeResult, sweep_rates

ECFG = EngineConfig(slots=3, page_size=4, prompt_len=8, max_gen=6, max_requests=16)
TRACE = TraceConfig(n_requests=6, prompt_len=8, min_gen=1, max_gen=6, slo_ms=300.0)
RATES = [5.0, 40.0, 400.0]
COLUMNS = ("completed", "decode_steps", "tokens_generated", "virtual_ms", "goodput_rps",
           "tokens_per_s", "energy_j", "slo_violations", "percentiles")
COUNTS = ("completed", "rejected", "decode_steps", "prefills", "cold_starts",
          "tokens_generated", "slo_violations")
F32 = dict(param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def served():
    torch.manual_seed(0)
    model = build_model(get_reduced("llama3.2-1b", param_dtype="float32",
                                    compute_dtype="float32"))
    g = torch.Generator()
    g.manual_seed(0)
    params = model.init(g)
    engine = ContinuousBatchingEngine(model, params, ECFG)
    programs = (engine._admit, engine._decode, engine.num_pages)
    res = sweep_rates(engine, TRACE, RATES, seed=4)
    return model, params, engine, programs, res


def test_columns_equal_standalone_serves(served):
    model, params, _, _, res = served
    assert isinstance(res, SweepServeResult) and len(res.reports) == len(RATES)
    np.testing.assert_array_equal(res.rates_per_s, RATES)
    for g, rate in enumerate(RATES):
        trace = make_trace(TorchDraws(4 + g, "cpu"),
                           dataclasses.replace(TRACE, rate_per_s=rate), model.cfg)
        rep = ContinuousBatchingEngine(model, params, ECFG).serve(trace)
        for name in COLUMNS:
            want = rep.percentiles["p95"] if name == "percentiles" else getattr(rep, name)
            assert res.column(name)[g] == want, (name, g)
        for req in range(trace.n_requests):
            assert res.reports[g].tokens_for(req) == rep.tokens_for(req)
    # offered load is data: a higher rate never finishes later in virtual time
    assert res.column("completed").tolist() == [TRACE.n_requests] * len(RATES)
    assert res.column("virtual_ms")[0] >= res.column("virtual_ms")[-1]


def _copying_host_arrays(fn):
    """The JAX engine hands host arrays to its asynchronously dispatched
    decode program and then changes them in place (ROADMAP.md, "Seed
    tests that flip"); a fresh copy of each keeps its reads defined."""
    return lambda *args: fn(*(a.copy() if isinstance(a, np.ndarray) else a for a in args))


def test_columns_and_tokens_match_the_jax_sweep():
    jcfg = jax_reduced("llama3.2-1b", loss_chunk=0, **F32)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jengine = JaxEngine(jm, jp, JaxEngineConfig(**dataclasses.asdict(ECFG)))
    jengine._decode = _copying_host_arrays(jengine._decode)
    want = jax_sweep_rates(jengine, JaxTraceConfig(**dataclasses.asdict(TRACE)), RATES, seed=4)

    tcfg = get_reduced("llama3.2-1b", **F32)
    tp = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    got = sweep_rates(ContinuousBatchingEngine(build_model(tcfg), tp, ECFG), TRACE, RATES,
                      seed=4, draws=JaxDraws)
    np.testing.assert_array_equal(got.rates_per_s, want.rates_per_s)
    for name in COUNTS:
        np.testing.assert_array_equal(got.column(name), want.column(name), err_msg=name)
    for name in ("virtual_ms", "energy_j", "goodput_rps", "tokens_per_s", "percentiles"):
        np.testing.assert_allclose(got.column(name), want.column(name), rtol=1e-12,
                                   err_msg=name)
    for g in range(len(RATES)):
        np.testing.assert_allclose(got.reports[g].latency_ms, want.reports[g].latency_ms,
                                   rtol=1e-12)
        for req in range(TRACE.n_requests):
            assert got.reports[g].tokens_for(req) == want.reports[g].tokens_for(req), (g, req)


def test_the_grid_rides_one_engine(served):
    _, _, engine, programs, _ = served
    assert engine._admit is programs[0] and engine._decode is programs[1]
    assert engine.num_pages == programs[2]


def test_async_engine_cli_smoke_on_the_cpu(capsys):
    from repro_torch.sim.events.engine import _smoke

    h = _smoke(["--horizon-ms", "500", "--device", "cpu"])
    assert h["num_flushes"] > 0 and h["num_dispatches"] > 0
    assert "async smoke: horizon=500ms" in capsys.readouterr().out
