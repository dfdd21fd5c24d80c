"""The port's async engine (``repro_torch.sim.events``) against the JAX
package's on the same draws, and its own contracts on production draws.

Against the JAX engine (``_async_parity.check_async``, at
``check_three_rounds``' tolerances): the cohort (sync-recovery)
configuration, FedAsync and FedBuff in interval mode, and interval
dispatching with a straggler tail. The faults, churn, fog and robust
cases are in ``test_torch_async_engine_faults.py``.

On production draws (``TorchDraws``): the coalesced loop equals the
single-pop loop bit for bit; cohort mode equals the port's own
``run_scanned()``; repeat flushes between two dispatches draw fresh DP
noise; and the engine's accounting holds (FedBuff flush sizes, cold
starts conserved, staleness accrues under overlap, churn losses warn).
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch
from _async_parity import one_thread, SMALL, check_async  # noqa: F401 (autouse)

from repro_torch.fl.simulator import FedFogSimulator, SimulatorConfig
from repro_torch.obs import MemoryTracker, MetricTap
from repro_torch.sim.events import AsyncConfig, AsyncFedFogSimulator, ChurnConfig
from repro_torch.sim.faults import FaultConfig


# --------------------------------------------------------------------- #
# against the JAX engine
# --------------------------------------------------------------------- #
def test_cohort_mode_matches_jax():
    h = check_async({}, dict(staleness_exponent=0.0))
    assert h["num_flushes"] == SMALL["rounds"]


def test_fedasync_matches_jax():
    h = check_async({}, dict(ctor="fedasync", dispatch_interval_ms=200.0,
                             straggler_sigma=0.5))
    assert h["num_flushes"] >= h["num_completions"] > 0


def test_fedbuff_matches_jax():
    check_async(dict(rounds=4, top_k=6),
                dict(ctor="fedbuff", k=3, dispatch_interval_ms=500.0))


def test_interval_stragglers_stale_matches_jax():
    """Overlapping cohorts under a straggler tail: the flushes aggregate
    stale updates (K3's staleness route on CPU tensors: its plain
    version), as the JAX engine does."""
    h = check_async(dict(rounds=4, top_k=6, drift_period=2),
                    dict(ctor="fedbuff", k=2, dispatch_interval_ms=150.0,
                         straggler_sigma=0.6, staleness_exponent=0.7))
    assert max(h["mean_staleness"]) > 0


# --------------------------------------------------------------------- #
# production draws
# --------------------------------------------------------------------- #
def _cfg(**kw):
    return SimulatorConfig(**dict(SMALL, **kw))


BITWISE_CASES = {
    "cohort": (dict(), AsyncConfig(staleness_exponent=0.0)),
    "fedasync": (dict(rounds=4), AsyncConfig.fedasync(dispatch_interval_ms=200.0,
                                                      straggler_sigma=0.5)),
    "fedbuff-churn": (dict(rounds=4), AsyncConfig.fedbuff(
        3, dispatch_interval_ms=300.0, straggler_sigma=0.4,
        churn=ChurnConfig(arrival_rate=0.2, departure_rate=0.8))),
    "faults-deadline": (dict(faults=FaultConfig(crash_rate=0.5, max_retries=2,
                                                corrupt_rate=0.3, deadline_ms=4000.0,
                                                quorum_frac=0.25)),
                        AsyncConfig()),
    "faults-interval": (dict(rounds=4, faults=FaultConfig(
        crash_rate=0.4, drop_rate=0.1, max_retries=2, corrupt_rate=0.3,
        deadline_ms=6000.0)), AsyncConfig.fedbuff(3, dispatch_interval_ms=300.0,
                                                  straggler_sigma=0.3)),
}


@pytest.mark.parametrize("case", list(BITWISE_CASES))
def test_coalesced_matches_single_pop_bitwise(case):
    """Coalesced stepping changes only the execution: every flush channel,
    counter and the final parameters equal the single-pop oracle's bit for
    bit, same-timestamp ties and mid-batch buffer_k boundaries included;
    the coalesced loop takes fewer steps."""
    over, acfg = BITWISE_CASES[case]
    cfg = _cfg(**over)
    fast = AsyncFedFogSimulator(cfg, dataclasses.replace(acfg, coalesce=True), device="cpu")
    oracle = AsyncFedFogSimulator(cfg, dataclasses.replace(acfg, coalesce=False),
                                  device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        sf = fast._scan_events(fast.init_state(0))
        so = oracle._scan_events(oracle.init_state(0))
    for k in sf.m_flush:
        assert torch.equal(sf.m_flush[k], so.m_flush[k]), k
    for k in ("completions", "lost_inflight", "fault_retries", "fault_terminal",
              "fault_lost_deadline", "fault_corrupt", "fault_failures", "t_ms"):
        assert torch.equal(getattr(sf, k), getattr(so, k)), k
    assert torch.equal(sf.queue.dropped, so.queue.dropped)
    for a, b in zip(sf.params, so.params):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert sf.flush_idx == so.flush_idx > 0
    assert fast.steps <= oracle.steps
    if case.startswith("faults"):
        assert int(sf.fault_retries) > 0


@pytest.mark.parametrize("policy,buffer_k", [("fedfog", None), ("fogfaas", None),
                                             ("fedfog", 8)])
def test_cohort_mode_matches_run_scanned(policy, buffer_k):
    """Sync recovery on production draws: an unbounded buffer (or one the
    size of the registry, which never count-triggers), no churn and no
    staleness discount replay the port's own synchronous rounds."""
    cfg = _cfg(policy=policy, rounds=4)
    h_sync = FedFogSimulator(cfg, device="cpu").run_scanned()
    h_async = AsyncFedFogSimulator(
        cfg, AsyncConfig(buffer_k=buffer_k, staleness_exponent=0.0), device="cpu").run()
    assert h_async["num_flushes"] == cfg.rounds
    np.testing.assert_allclose(h_async["accuracy"], h_sync["accuracy"], atol=2 / 512)
    np.testing.assert_allclose(h_async["update_latency_ms"], h_sync["round_latency_ms"],
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(h_async["energy_j"], h_sync["energy_j"], rtol=1e-5,
                               atol=1e-5)
    assert h_async["cold_starts"] == h_sync["cold_starts"]
    assert h_async["num_aggregated"] == h_sync["num_selected"]
    assert all(s == 0.0 for s in h_async["mean_staleness"])


def test_flush_draws_decorrelate_repeat_flushes():
    """With lr=0 the client deltas are zero, so each flush's parameter
    change is its DP noise: two flushes after one dispatch draw different
    noise (the second folds in its use count)."""
    cfg = _cfg(rounds=2, lr=0.0, dp_sigma=0.5, clip_norm=1.0)
    sim = AsyncFedFogSimulator(cfg, AsyncConfig.fedasync(dispatch_interval_ms=1e9,
                                                         coalesce=False), device="cpu")
    state = sim._single_step(sim.init_state(0))  # the dispatch
    assert int(state.busy.sum()) >= 2, "need >= 2 in-flight updates"
    p0 = state.params
    state = sim._single_step(state)  # a completion and flush 1
    p1 = state.params
    state = sim._single_step(state)  # flush 2
    p2 = state.params
    assert state.flush_idx == 2 and state.key_uses == 2
    flat = lambda a, b: torch.cat([(y[k] - x[k]).reshape(-1)  # noqa: E731
                                   for x, y in zip(a, b) for k in ("w", "b")])
    n1, n2 = flat(p0, p1), flat(p1, p2)
    assert n1.abs().max() > 0 and n2.abs().max() > 0
    assert not torch.allclose(n1, n2), "repeat flushes reused the dispatch's DP draw"


def test_fedbuff_flush_sizes():
    k = 3
    h = AsyncFedFogSimulator(_cfg(rounds=8, top_k=6),
                             AsyncConfig.fedbuff(k, dispatch_interval_ms=500.0),
                             device="cpu").run()
    sizes = h["num_aggregated"]
    assert sizes and all(s <= k for s in sizes) and any(s == k for s in sizes)
    assert sum(sizes) == h["num_completions"]


def test_flush_cold_starts_conserved():
    """Cold starts are consumed by the first flush after their dispatch:
    Σ flush cold starts == Σ dispatch cold starts under FedAsync."""
    h = AsyncFedFogSimulator(_cfg(rounds=6, top_k=6),
                             AsyncConfig.fedasync(dispatch_interval_ms=1e9),
                             device="cpu").run()
    assert h["num_flushes"] > h["num_dispatches"]
    assert sum(h["dispatch_cold_starts"]) > 0
    assert sum(h["cold_starts"]) == sum(h["dispatch_cold_starts"])


def test_churn_drops_inflight_updates_and_warns():
    sim = AsyncFedFogSimulator(
        _cfg(rounds=10, num_clients=16, top_k=12),
        AsyncConfig.fedbuff(4, dispatch_interval_ms=300.0, straggler_sigma=0.4,
                            churn=ChurnConfig(arrival_rate=0.2, departure_rate=0.8)),
        device="cpu")
    with pytest.warns(RuntimeWarning, match="never reported"):
        h = sim.run()
    assert h["lost_inflight"] > 0 and h["num_flushes"] > 0
    # The queue drained, so nothing is in flight or buffered: every admitted
    # update arrived or was lost, and every arrival was aggregated.
    assert sum(h["dispatch_num_admitted"]) == h["num_completions"] + h["lost_inflight"]
    assert sum(h["num_aggregated"]) == h["num_completions"]


def test_tap_rows_and_history_unchanged():
    cfg = _cfg(rounds=4)
    acfg = AsyncConfig.fedbuff(2, dispatch_interval_ms=300.0)
    h0 = AsyncFedFogSimulator(cfg, acfg, device="cpu").run()
    tracker = MemoryTracker()
    h1 = AsyncFedFogSimulator(cfg, acfg, device="cpu",
                              tap=MetricTap(tracker, every=2)).run()
    assert h1 == h0
    assert [r["step"] for r in tracker.rows] == list(range(0, h0["num_flushes"], 2))
    for row in tracker.rows:
        assert row["accuracy"] == h1["accuracy"][row["step"]]
    assert len(tracker.summaries) == 1


def test_queue_overflow_raises_and_seed_mismatch_raises():
    sim = AsyncFedFogSimulator(_cfg(num_clients=6, top_k=6, hidden=(8,)),
                               AsyncConfig(queue_capacity=2), device="cpu")
    with pytest.raises(RuntimeError, match="overflow"):
        sim.run()
    with pytest.raises(ValueError, match="seed"):
        AsyncFedFogSimulator(_cfg(), device="cpu").run(seed=3)
    with pytest.raises(ValueError, match="dispatch_mode"):
        AsyncFedFogSimulator(_cfg(), AsyncConfig(dispatch_mode="poisson"), device="cpu")


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncFedFogSimulator(_cfg())
