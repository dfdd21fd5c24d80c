"""The port's client-sharded LM round on 8 CPU ranks, continued from
``test_torch_sharded_round.py`` (same references, tolerances and helper):
the fog tier over a population, on the multi-pod plan pod 2 × client 2 ×
zero 2 whose pod axis is the fog tier (one packed all-reduce confined to
the edge (client) axis, then one across the fog (pod) axis: two crossing
the client ranks), and the fault plan (crashes with retries, corrupted
payloads: the corruption's normals drawn for all slots, as on one
device, and cut to the rank's rows) on client 4 × zero 2; each with and
without ``use_pallas_agg``.
"""
import pytest
from _lm_parity import MODEL_TOL, one_thread  # noqa: F401 (autouse)
from _sharded_round import hold_ranks, jax_runs, models, run_case, world  # noqa: F401

CASES = {
    "fog-population": dict(fog_nodes=2, population=40),
    "faults": dict(faults=dict(crash_rate=0.3, max_retries=2, corrupt_rate=0.3)),
}


@pytest.mark.parametrize("pallas", [False, True], ids=["plain-path", "kernel-path"])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_round_matches_jax(world, models, jax_runs, case, pallas):  # noqa: F811
    out = run_case(world, models, jax_runs, CASES[case], pallas)
    ranks = out[-1]
    hold_ranks(*out, MODEL_TOL, zero_ops=2,
               contract=2 if case == "fog-population" else 1)
    if case == "faults":
        m = ranks[0]["metrics"]
        assert sum(r["fault_retries"] for r in m) > 0
        assert all(r["fault_dispatched"] == r["fault_completed"] + r["fault_terminal"]
                   + r["fault_lost"] for r in m)
