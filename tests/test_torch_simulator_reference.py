"""The reference branch of the port's dense round (``use_pallas_agg=False``:
``core.aggregation`` + ``core.privacy``) against the JAX simulator, three
rounds from one state with the JAX package's draws (tolerances in
``test_torch_simulator.py``, whose ``check_three_rounds`` runs it)."""
from test_torch_simulator import check_three_rounds
from _threads import one_thread  # noqa: F401 (autouse)


def test_reference_trimmed_dp_rcs_matches_jax():
    """Core trimmed mean, the Gaussian mechanism, the RCS baseline and
    top-k compression."""
    check_three_rounds(use_pallas_agg=False, aggregator="trimmed", dp_sigma=0.05,
                       policy="rcs", compression="topk")
