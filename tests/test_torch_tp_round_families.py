"""The tensor-parallel LM round on the other DENSE configurations, reduced
in float32 on 4 CPU ranks against the single-device JAX round and the
port's single-process round (``_tp_round``; see
``test_torch_tp_round.py``): qwen2.5-14b (qkv bias, untied head) and
gemma3-12b (``qk_norm``, tied head, scaled embeddings, sliding windows),
gates legacy, on (client, zero, tp, sp) = (1, 1, 2, 2) (the ``head_dim``
split over sp: RoPE and ``qk_norm`` on gathered q and k), (1, 1, 4, 1)
(the 2 kv heads replicated over tp 4) and (2, 1, 2, 1), with and without
``use_pallas_agg``."""
import pytest
from _lm_parity import MODEL_TOL, one_thread  # noqa: F401 (autouse)
from _tp_round import hold_blocks, hold_tp, run_tp_case, world  # noqa: F401 (fixture)


@pytest.mark.parametrize("split,pallas", [((1, 1, 2, 2), True), ((1, 1, 4, 1), True),
                                          ((2, 1, 2, 1), False)],
                         ids=["tp2-sp2", "tp4-kv-replicated", "client2-tp2-plain-path"])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-12b"])
def test_tp_round_families_match_jax(world, arch, split, pallas):
    out = run_tp_case(world, arch, "legacy", pallas, split)
    hold_tp(*out, MODEL_TOL, split)
    hold_blocks(arch, out[-1], split)
