"""Serving under mesh rules on 4 CPU ranks (gloo) against the JAX
package's single-device model (the reduced llama3.2-1b in float32, the
JAX parameters carried across with numpy):

  * tp 2 × sp 2: each rank one of the four query heads' halves of
    ``head_dim``, q / k / v gathered over sp, the MLP and vocabulary over
    all four;
  * tp 4 over the config's 2 kv heads (which do not divide): each rank's
    cache holds the one kv head its query head reads;
  * the sequence split over 4 data ranks (client 2 × zero 2) with spans
    of 6, 6, 6 and 4 cache positions, the last rank's span past every
    decode position at first (it takes part in the merge with nothing
    visible);
  * tp 2 within each of two data ranks: batch-parallel rows and the
    sequence split composed with the model split.

Every step's whole logits within ``LOGIT_TOL`` of the JAX ``prefill`` /
``decode_step`` and the greedy tokens equal; the decode census per
layout as a formula in the layers L.
"""
import numpy as np
import pytest
from _serve_dist_cases import rank_prefill_decode
from _serve_dist_jax import jax_setup, jax_static, random_batch
from _threads import one_thread  # noqa: F401 (autouse)

from repro_torch.dist.world import World

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
S = 16
L = 2


@pytest.fixture(scope="module")
def world():
    with World(4, backend="gloo", device="cpu", timeout=300.0) as w:
        yield w


@pytest.fixture(scope="module")
def llama():
    return jax_setup("llama3.2-1b")


# (case, split, batch, cache_len, layout kind, census, kv heads a rank)
CASES = [
    ("tp2-sp2", (1, 1, 2, 2), 3, S + 4, "replicated",
     {"all-reduce": 2 * L + 1, "all-gather": L + 1}, 1),
    ("tp4-kv-held", (1, 1, 4, 1), 3, S + 4, "replicated",
     {"all-reduce": 2 * L + 1, "all-gather": 1}, 1),
    ("sequence-4", None, 1, S + 6, "sequence", {"all-reduce": 2 * L}, 2),
    ("batch-2-tp2", (2, 1, 2, 1), 4, S + 4, "batch",
     {"all-reduce": 2 * L + 1, "all-gather": 1}, 1),
    ("sequence-2-tp2", (2, 1, 2, 1), 1, S + 4, "sequence",
     {"all-reduce": 4 * L + 1, "all-gather": 1}, 1),
]


@pytest.mark.parametrize("name,split,b,cache_len,kind,want,hkv", CASES,
                         ids=[c[0] for c in CASES])
def test_prefill_and_decode_match_jax(world, llama, name, split, b, cache_len, kind, want,
                                      hkv):
    cfg, jm, jp = llama
    steps = cache_len - S
    batch = random_batch(cfg, b, S, seed=10 + b)
    ref_logits, ref_toks = jax_static(jm, jp, batch, cache_len, steps)
    out = world.run(rank_prefill_decode, dict(arch="llama3.2-1b", split=split, params=jp,
                                              batch=batch, cache_len=cache_len, steps=steps))
    for r in out:
        assert r["kind"] == kind
        assert r["census"] == want, r["census"]
        assert r["cache_shape"][3:] == (hkv, cfg.head_dim)
        np.testing.assert_array_equal(r["tokens"], ref_toks)
        for got, ref in zip(r["logits"], ref_logits):
            np.testing.assert_allclose(got, ref, **LOGIT_TOL)
    if name == "sequence-4":
        assert [r["span"] for r in out] == [(0, 6), (6, 12), (12, 18), (18, 22)]
