"""More of the port's LM round against the JAX package's (tolerances in
``_lm_parity.py`` unless a case states its own; cases (i)-(iv) and (ix)
are in ``test_torch_lm_round.py``): (v) the median and
trimmed mean on the kernel path (``robust_kernel``'s plain version),
(vi) clip + DP noise + int8 on the kernel path (K2's and K3's plain
versions), (vii) AdamW with gradient accumulation, (viii) the noise
attack under a fault plan, and on the kernel path model replacement
under corrupted payloads and a quorum that skips rounds 1 and 3 (the
delta tree's clip, attack and fault noise written back into the fused
buffer), three rounds each."""
import pytest
from _lm_parity import MODEL_TOL, check_rounds, one_thread  # noqa: F401

# int8 rounds each delta to a multiple of its (client, leaf) quantum
# max|Δ| / 127 (~1e-4 here); a delta that XLA and ATen compute a few ulps
# apart can round to the neighbouring multiple, so a parameter may move
# by one quantum times its Eq. 6 weight more or less, carried on by the
# server momentum (1 + 0.9 + 0.81 over three rounds).
INT8_TOL = dict(rtol=1e-4, atol=5e-4)
# AdamW steps every element by ~lr whatever its gradient's size: its
# first step is lr·g / (|g| + 1e-8), whose value (even sign) for a gradient
# of ~1e-8 (a sum that cancels to rounding noise) depends on g's last
# bits. So a few elements (~0.1 % of a leaf) may differ by up to the step
# size, and from the next round on every gradient, hence every step,
# feels them. The AdamW case therefore holds each round on its own, from
# the JAX state (``resync``): at most 0.5 % of a leaf beyond MODEL_TOL,
# and every element within the two local steps' reach, 2·E·lr = 0.08.
ADAM_LOOSE = 0.005
ADAM_CAP = dict(rtol=0.0, atol=0.08)


@pytest.mark.parametrize("over,attack,tol,held", [
    (dict(use_pallas_agg=True, aggregator="median"), None, MODEL_TOL, {}),
    (dict(use_pallas_agg=True, aggregator="trimmed"), None, MODEL_TOL, {}),
    (dict(use_pallas_agg=True, clip_norm=1.0, dp_sigma=0.1, compression="int8"),
     None, INT8_TOL, {}),
    (dict(inner_optimizer="adamw", microbatch=2), None, MODEL_TOL,
     dict(loose=ADAM_LOOSE, cap=ADAM_CAP, resync=True)),
    (dict(faults=dict(crash_rate=0.3, max_retries=2)),
     dict(kind="noise", fraction=0.25), MODEL_TOL, {}),
    (dict(use_pallas_agg=True, faults=dict(crash_rate=0.5, corrupt_rate=0.4,
                                           quorum_frac=0.6)),
     dict(kind="model_replacement", fraction=0.25), MODEL_TOL, {}),
], ids=["median-kernel", "trimmed-kernel", "clip-dp-int8-kernel", "adamw-microbatch",
        "noise-attack-faults", "replacement-corrupt-quorum-kernel"])
def test_round_matches_jax(over, attack, tol, held):
    jms, _ = check_rounds(over, attack, tol=tol, **held)
    if "faults" in over:  # the plan fired
        fc = over["faults"]
        assert sum(int(m["fault_retries"]) for m in jms) > 0 or not fc.get("max_retries")
        if fc.get("quorum_frac"):
            assert [int(m["round_skipped"]) for m in jms] == [1, 0, 1]
            assert sum(int(m["fault_corrupt"]) for m in jms) > 0
