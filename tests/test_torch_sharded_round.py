"""The port's client-sharded LM round (``make_round_fn(rules=...)``) on 8
CPU ranks (``dist.world``, gloo; plan client 4 × zero 2), against the
single-device JAX round and the port's single-process round.

The JAX package's own sharded round fails its selftests on this tree
(ROADMAP R3), so the reference is its single-device round: reduced
llama3.2-1b in float32, ``_lm_parity``'s configuration (16 clients, 4
slots, 2 local steps), two rounds from the JAX initial state. The port's
single-process round draws from ``JaxDraws`` through ``_dist_cases.
Recording``; each rank replays those blocks. Held:

  * metrics (``_lm_parity.hold_metrics``: integers exactly, floats to
    ``METRIC_TOL``) and the final state (``hold_state``: ``MODEL_TOL``;
    under int8 the LM tests' ``INT8_TOL``, a delta rounding to the
    neighbouring quantum) against JAX; the same against the port's
    single-process round; every rank's state equal to rank 0's
    (replicated);
  * the contract on every rank's ``CollectiveLog`` each round: ONE
    delta-sized all-reduce across the client ranks; the zero axis's
    gradient all-reduces (one a local step of each of the rank's slots)
    confined to the zero axis, none crossing clients.

Gate sets plain (FedAvg), legacy (FedAvgM) and full (clip, DP, int8,
FedAvgM), each with and without ``use_pallas_agg``; the fog tier with a
population and the fault plan are in ``test_torch_sharded_round_fog.py``.
"""
import pytest
from _lm_parity import MODEL_TOL, one_thread  # noqa: F401 (autouse)
from _sharded_round import (  # noqa: F401 (fixtures)
    GATES,
    INT8_TOL,
    hold_ranks,
    jax_runs,
    models,
    run_case,
    world,
)


@pytest.mark.parametrize("pallas", [False, True], ids=["plain-path", "kernel-path"])
@pytest.mark.parametrize("gates", list(GATES))
def test_sharded_round_matches_jax(world, models, jax_runs, gates, pallas):
    out = run_case(world, models, jax_runs, GATES[gates], pallas)
    tol = INT8_TOL if gates == "full" else MODEL_TOL
    # one zero all-reduce a local step (2) of the rank's one slot
    hold_ranks(*out, tol, zero_ops=2)

