"""The port's observability (``repro_torch.obs``): trackers against the
JAX package's, and the metric taps on the simulator and the serving
engine.

  * the trackers write what the JAX package's write (JSONL rows with
    their timestamps left out, CSV files byte for byte, memory rows);
  * a tap that is off (``tap=None``, ``every=0``) or on leaves the
    history bitwise as it is;
  * a tap's decimated rows equal the history at their rounds, ``run()``
    emits the rows ``run_scanned()`` does, and the summary row carries
    the shared schema;
  * the serving engine's tap emits one row per ``every`` decode steps
    with the engine's own counters, and ``launch/serve.py --track``
    writes them to a file.
"""
import json

import numpy as np
import pytest
from _threads import one_thread  # noqa: F401 (autouse)

from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.fl.simulator import FedFogSimulator, SimulatorConfig
from repro_torch.sim.faults import FaultConfig

SMALL = dict(num_clients=8, hidden=(16,), top_k=4, local_batch=8, local_epochs=2,
             use_pallas_agg=True, rounds=6)


def _log_both(make, tmp_path, name):
    """The same rows through a JAX tracker and a port tracker."""
    out = []
    for pkg, tag in ((jobs, "jax"), (tobs, "torch")):
        path = tmp_path / f"{tag}.{name}"
        with make(pkg, str(path)) as t:
            t.log({"event": "round", "accuracy": 0.5, "n": np.int32(3)}, step=0)
            t.log({"event": "round", "accuracy": 0.625, "n": 4, "extra": 9.0}, step=1)
            t.log_summary({"final_accuracy": np.float32(0.75)})
        out.append(path.read_text())
    return out


def test_jsonl_tracker_matches_jax(tmp_path):
    a, b = _log_both(lambda pkg, p: pkg.JsonlTracker(p), tmp_path, "jsonl")
    strip = lambda text: [{k: v for k, v in json.loads(x).items() if k != "ts"}  # noqa: E731
                          for x in text.splitlines()]
    assert strip(a) == strip(b) and len(strip(b)) == 3
    assert all("ts" in json.loads(x) for x in b.splitlines())


def test_csv_tracker_matches_jax(tmp_path):
    a, b = _log_both(lambda pkg, p: pkg.CsvTracker(p), tmp_path, "csv")
    assert a == b
    assert b.splitlines()[0].split(",")[:2] == ["step", "summary"]


def test_memory_and_composite_trackers_match_jax():
    rows = []
    for pkg in (jobs, tobs):
        a, b = pkg.MemoryTracker(), pkg.MemoryTracker()
        with pkg.CompositeTracker([a, b, pkg.NoopTracker()]) as t:
            t.log({"x": np.float64(1.5), "k": 2}, step=4)
            t.log_summary({"y": np.int64(2)})
        assert a.rows == b.rows and a.summaries == b.summaries
        rows.append((a.rows, a.summaries))
    assert rows[0] == rows[1]


def test_jsonl_rows_visible_mid_run(tmp_path):
    path = tmp_path / "t.jsonl"
    t = tobs.JsonlTracker(str(path))
    t.log({"x": 1.0}, step=0)
    assert len(path.read_text().splitlines()) == 1
    t.finish()
    t.finish()  # idempotent


def test_tracker_from_spec(tmp_path):
    assert isinstance(tobs.tracker_from_spec(None), tobs.NoopTracker)
    assert isinstance(tobs.tracker_from_spec("noop"), tobs.NoopTracker)
    assert isinstance(tobs.tracker_from_spec(f"jsonl:{tmp_path}/a.jsonl"),
                      tobs.JsonlTracker)
    assert isinstance(tobs.tracker_from_spec(f"csv:{tmp_path}/a.csv"), tobs.CsvTracker)
    both = tobs.tracker_from_spec(f"jsonl:{tmp_path}/b.jsonl,csv:{tmp_path}/b.csv")
    assert isinstance(both, tobs.CompositeTracker) and len(both.trackers) == 2
    for bad in ("wandb:project", "jsonl"):
        with pytest.raises(ValueError):
            tobs.tracker_from_spec(bad)


def test_tap_rejects_a_negative_interval():
    with pytest.raises(ValueError):
        tobs.MetricTap(tobs.MemoryTracker(), every=-1)
    assert not tobs.MetricTap(tobs.NoopTracker(), every=0).enabled


def _lists(h):
    return {k: v for k, v in h.items() if isinstance(v, list)}


@pytest.fixture(scope="module")
def untapped():
    return FedFogSimulator(SimulatorConfig(**SMALL), device="cpu").run_scanned()


def test_tap_off_is_bitwise_identical(untapped):
    zero = tobs.MetricTap(tobs.MemoryTracker(), every=0)
    sim = FedFogSimulator(SimulatorConfig(**SMALL), device="cpu", tap=zero)
    assert sim.tap is None
    assert sim.run_scanned() == untapped
    assert zero.rows_emitted == 0 and zero.tracker.rows == []


@pytest.mark.parametrize("engine", ["run_scanned", "run"])
def test_tap_rows_equal_the_history(untapped, engine):
    """Rows at 0, 4 equal the history there (float64 transfer: exact),
    the history equals the untapped one, and the summary row carries the
    shared schema."""
    mt = tobs.MemoryTracker()
    tap = tobs.MetricTap(mt, every=4, const={"policy": "fedfog"})
    h = getattr(FedFogSimulator(SimulatorConfig(**SMALL), device="cpu", tap=tap),
                engine)()
    assert h == untapped
    assert [r["step"] for r in mt.rows] == [0, 4] and tap.rows_emitted == 2
    names = set(_lists(h))
    for r in mt.rows:
        assert r["event"] == "round" and r["policy"] == "fedfog"
        assert set(r) - {"event", "policy", "step"} == names
        for k in names:
            assert r[k] == h[k][r["step"]], k
    (s,) = mt.summaries
    assert s["policy"] == "fedfog"
    assert s["final_accuracy"] == h["final_accuracy"]
    assert s["total_energy_j"] == h["total_energy_j"]


def test_faulted_tap_streams_the_fault_counters():
    fc = FaultConfig(crash_rate=0.5, max_retries=2)
    mt_scan, mt_loop = tobs.MemoryTracker(), tobs.MemoryTracker()
    cfg = SimulatorConfig(**dict(SMALL, rounds=4), faults=fc, attack="noise",
                          attack_fraction=0.25)
    hs = FedFogSimulator(cfg, device="cpu", tap=tobs.MetricTap(mt_scan, every=2)
                         ).run_scanned()
    hl = FedFogSimulator(cfg, device="cpu", tap=tobs.MetricTap(mt_loop, every=2)).run()
    assert hs == hl and mt_scan.rows == mt_loop.rows
    assert [r["step"] for r in mt_scan.rows] == [0, 2]
    assert sum(r["fault_retries"] for r in mt_scan.rows) > 0


def test_serving_engine_tap_rows():
    """One row per 2 decode steps from the engine's host counters, each
    within the report's totals and the virtual clock increasing; the
    tapped engine serves the same tokens."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.random import TorchDraws
    from repro_torch.serve import (ContinuousBatchingEngine, EngineConfig, TraceConfig,
                                   make_trace)

    cfg = get_reduced("llama3.2-1b")
    model = build_model(cfg)
    g = torch.Generator()
    g.manual_seed(0)
    params = model.init(g)
    ecfg = EngineConfig(slots=2, page_size=4, prompt_len=8, max_gen=5, max_requests=8)
    trace = make_trace(TorchDraws(1, "cpu"), TraceConfig(
        n_requests=5, rate_per_s=200.0, slo_ms=8000.0, prompt_len=8, min_gen=2,
        max_gen=5), cfg)
    base = ContinuousBatchingEngine(model, params, ecfg).serve(trace)
    mt = tobs.MemoryTracker()
    rep = ContinuousBatchingEngine(model, params, ecfg,
                                   tap=tobs.MetricTap(mt, every=2, channel="serve")
                                   ).serve(trace)
    np.testing.assert_array_equal(rep.tokens, base.tokens)
    assert [r["step"] for r in mt.rows] == list(range(2, rep.decode_steps + 1, 2))
    for r in mt.rows:
        assert r["event"] == "serve"
        assert set(r) == {"event", "step", "virtual_ms", "active_slots", "waiting",
                          "completed", "tokens_generated", "energy_j"}
        assert 1 <= r["active_slots"] <= 2 and r["tokens_generated"] <= rep.tokens_generated
    assert all(a["virtual_ms"] < b["virtual_ms"] for a, b in zip(mt.rows, mt.rows[1:]))


@pytest.mark.parametrize("engine", ["continuous", "static"])
def test_launcher_track_writes_rows(tmp_path, engine):
    from repro_torch.launch import serve as launch

    path = tmp_path / "serve.jsonl"
    out = launch.main(["--device", "cpu", "--engine", engine, "--requests", "3",
                       "--gen", "4", "--prompt-len", "8", "--page-size", "4",
                       "--track", f"jsonl:{path}", "--track-every", "1"])
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    assert rows and all(r["event"] == "serve" and r["arch"] == "llama3.2-1b-reduced"
                        for r in rows)
    n_steps = out.decode_steps if engine == "continuous" else 3
    assert [r["step"] for r in rows] == list(range(1, n_steps + 1))
