"""The port's async engine against the JAX package's on the same draws
(``_async_parity.check_async``, at ``check_three_rounds``' tolerances):
churn, event-level faults (retries, corruption, the deadline with its
quorum rule, in both dispatch modes), a two-fog tier through K4's
staleness route, and the median (K3's ``robust_kernel`` route, staleness
left out) under the noise attack."""
from _async_parity import one_thread, check_async  # noqa: F401 (autouse)


def test_churn_matches_jax():
    h = check_async(dict(rounds=4), dict(
        ctor="fedbuff", k=3, dispatch_interval_ms=300.0, straggler_sigma=0.4,
        churn=dict(arrival_rate=0.2, departure_rate=0.8, initial_online_frac=0.8)))
    assert h["lost_inflight"] > 0


def test_faults_on_flush_deadline_matches_jax():
    h = check_async(dict(faults=dict(crash_rate=0.5, max_retries=2, deadline_ms=4000.0,
                                     quorum_frac=0.25, corrupt_rate=0.2)), {})
    assert h["fault_retries"] > 0 and h["fault_terminal"] > 0
    assert h["fault_lost_deadline"] > 0 and h["fault_corrupt"] > 0


def test_faults_interval_matches_jax():
    h = check_async(dict(rounds=4, faults=dict(
        crash_rate=0.4, drop_rate=0.1, timeout_rate=0.3, partition_rate=0.5,
        max_retries=2, deadline_ms=6000.0, corrupt_rate=0.3)),
        dict(ctor="fedbuff", k=3, dispatch_interval_ms=300.0, straggler_sigma=0.3))
    assert h["fault_retries"] > 0 and h["fault_failures"] > 0


def test_quorum_skip_matches_jax():
    """Every attempt crashes: each cohort ends below quorum at its deadline
    (or in terminal failures), so rounds are skipped."""
    h = check_async(dict(faults=dict(crash_rate=1.0, max_retries=1, deadline_ms=3000.0,
                                     quorum_frac=0.5)), {})
    assert h["fault_skipped"] + h["fault_terminal"] > 0


def test_fog_two_matches_jax():
    check_async(dict(fog_nodes=2, rounds=4, top_k=6),
                dict(ctor="fedbuff", k=3, dispatch_interval_ms=300.0, straggler_sigma=0.3))


def test_fog_outage_matches_jax():
    h = check_async(dict(fog_nodes=2, faults=dict(fog_outage_rate=0.5, crash_rate=0.2,
                                                  max_retries=1)),
                    dict(ctor="fedbuff", k=3, dispatch_interval_ms=300.0))
    assert h["fog_outages"] > 0


def test_median_noise_attack_matches_jax():
    check_async(dict(aggregator="median", attack="noise", attack_fraction=0.25,
                     rounds=4, top_k=6),
                dict(ctor="fedbuff", k=3, dispatch_interval_ms=300.0))


def test_population_matches_jax():
    """Population mode: the dispatch leases the slots to a candidate cohort
    of 64 virtual clients (the ``cohort.async`` draw) and the flush
    advances the owners' registry rows."""
    check_async(dict(population=64, rounds=4, top_k=6),
                dict(ctor="fedbuff", k=3, dispatch_interval_ms=300.0))
