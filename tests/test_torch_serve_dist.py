"""Serving under mesh rules on 2 CPU ranks (gloo) against the JAX
package's single-device model: the reduced llama3.2-1b in float32, the
JAX parameters carried across with numpy (each rank keeps its blocks).

  * ``prefill`` and greedy ``decode_step`` on tensor-parallel blocks (tp
    2; sp 2, q / k / v gathered over ``head_dim``; K5's plain version
    under ``attn_impl="flash"``), sequence-parallel (batch 3 and 1: each
    rank prefills half the prompt against the gathered keys and keeps its
    span of the cache, even and uneven, with and without a sliding
    window) and batch-parallel (2 rows a rank) against the JAX
    ``prefill`` / ``decode_step``: every step's whole logits within
    ``LOGIT_TOL`` and the greedy tokens equal;
  * the continuous engine over tp 2 (dense and paged modes) against the
    JAX ``SequentialOracle`` token for token (not the JAX engine, whose
    outcome changes from run to run, ROADMAP.md R2);
  * the decode census per layout, as a formula in the layers L: tp 2
    2L + 1 all-reduces and 1 all-gather, sp 2 also L all-gathers of q,
    k and v, the sequence split 2L all-reduces, batch-parallel none.

Float32 everywhere: the row-parallel partial sums and the merged
softmax add in another order than the single device, ~1e-7 of the
logits; ``LOGIT_TOL`` leaves two orders of magnitude above that.
"""
import dataclasses

import jax
import numpy as np
import pytest
from _serve_dist_cases import rank_continuous, rank_prefill_decode
from _serve_dist_jax import jax_setup, jax_static, random_batch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import SequentialOracle as JaxOracle
from repro.serve import TraceConfig as JaxTraceConfig
from repro.serve import make_trace as jax_make_trace
from repro_torch.dist.world import World

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
S = 16  # prompt length
TP2, SP2 = (1, 1, 2, 1), (1, 1, 1, 2)
L = 2  # the reduced llama's layers


@pytest.fixture(scope="module")
def world():
    with World(2, backend="gloo", device="cpu", timeout=300.0) as w:
        yield w


@pytest.fixture(scope="module")
def llama():
    return jax_setup("llama3.2-1b")


def census(kind: str) -> dict:
    return {"tp2": {"all-reduce": 2 * L + 1, "all-gather": 1},
            "sp2": {"all-reduce": 2 * L + 1, "all-gather": L + 1},
            "sequence": {"all-reduce": 2 * L},
            "batch": {}}[kind]


# (case, split, batch, cache_len, config overrides, layout kind, census)
CASES = [
    ("tp2", TP2, 3, S + 6, {}, "replicated", "tp2"),
    ("tp2-flash", TP2, 3, S + 6, dict(attn_impl="flash"), "replicated", "tp2"),
    ("sp2", SP2, 3, S + 6, {}, "replicated", "sp2"),
    ("sequence-even", None, 1, S + 8, {}, "sequence", "sequence"),
    ("sequence-uneven", None, 3, S + 5, {}, "sequence", "sequence"),
    ("sequence-window-flash", None, 1, S + 5, dict(window_pattern=(5,), attn_impl="flash"),
     "sequence", "sequence"),
    ("batch", None, 4, S + 6, {}, "batch", "batch"),
]


@pytest.mark.parametrize("name,split,b,cache_len,over,kind,want", CASES,
                         ids=[c[0] for c in CASES])
def test_prefill_and_decode_match_jax(world, llama, name, split, b, cache_len, over, kind,
                                      want):
    steps = cache_len - S
    jover = {k: v for k, v in over.items() if k != "attn_impl"}  # JAX: plain attention
    cfg, jm, jp = jax_setup("llama3.2-1b", jover) if jover else llama
    batch = random_batch(cfg, b, S, seed=b)
    ref_logits, ref_toks = jax_static(jm, jp, batch, cache_len, steps)
    spec = dict(arch="llama3.2-1b", over=over, split=split, params=jp, batch=batch,
                cache_len=cache_len, steps=steps)
    out = world.run(rank_prefill_decode, spec)
    for r in out:
        assert r["kind"] == kind
        assert r["census"] == census(want), r["census"]
        np.testing.assert_array_equal(r["tokens"], ref_toks)
        for got, ref in zip(r["logits"], ref_logits):
            np.testing.assert_allclose(got, ref, **LOGIT_TOL)
    if kind == "sequence":  # each rank holds its span of the cache
        per = -(-cache_len // 2)
        assert [r["span"] for r in out] == [(0, per), (per, cache_len)]
        assert [r["cache_shape"][2] for r in out] == [per, cache_len - per]
    if kind == "batch":
        assert [r["rows"] for r in out] == [(0, b // 2), (b // 2, b)]
    if split == TP2:  # one of the two kv heads a rank, head_dim whole
        assert all(r["cache_shape"][3:] == (1, cfg.head_dim) for r in out)


ECFG = dict(slots=3, page_size=4, prompt_len=8, max_gen=6, max_requests=16)
TRACE = dict(n_requests=8, rate_per_s=400.0, slo_ms=8000.0, prompt_len=8, min_gen=1,
             max_gen=6)


@pytest.mark.parametrize("attn,over", [("dense", {}), ("paged", dict(attn_impl="flash"))],
                         ids=["dense", "paged-flash"])
def test_continuous_engine_over_tp2_matches_the_jax_oracle(world, llama, attn, over):
    cfg, jm, jp = llama
    jt = jax_make_trace(jax.random.PRNGKey(3), JaxTraceConfig(**TRACE), cfg)
    ref = JaxOracle(jm, jp, JaxEngineConfig(**ECFG)).serve(jt)
    spec = dict(arch="llama3.2-1b", over=over, split=TP2, params=jp,
                ecfg=dict(ECFG, attn=attn),
                trace=dict(arrival_ms=np.asarray(jt.arrival_ms),
                           gen_len=np.asarray(jt.gen_len), prompts=np.asarray(jt.prompts),
                           slo_ms=float(jt.slo_ms)))
    out = world.run(rank_continuous, spec)
    for r in out:
        assert r["completed"] == TRACE["n_requests"] and r["rejected"] == 0
        assert r["census"] == census("tp2")
        assert r["kv_heads"] == (1, cfg.head_dim)
        for req in range(TRACE["n_requests"]):
            assert r["tokens"][req] == ref.tokens_for(req), req
    assert out[0]["decode_steps"] == out[1]["decode_steps"]


def test_sequence_split_prompt_must_divide(world, llama):
    """A prompt that does not divide over the data axes (and a batch that
    does not) is served replicated on every rank, as JAX's ``P()``."""
    cfg, jm, jp = llama
    batch = random_batch(cfg, 3, S - 1, seed=5)
    ref_logits, ref_toks = jax_static(jm, jp, batch, S + 2, 3)
    out = world.run(rank_prefill_decode, dict(arch="llama3.2-1b", split=None, params=jp,
                                              batch=batch, cache_len=S + 2, steps=3))
    for r in out:
        assert r["kind"] == "replicated" and r["census"] == {}
        np.testing.assert_array_equal(r["tokens"], ref_toks)
        np.testing.assert_allclose(r["logits"][-1], ref_logits[-1], **LOGIT_TOL)


def test_census_formula_matches_the_selftest():
    """The selftest's ``expected_census`` is the formula these tests assert."""
    from repro_torch.configs import get_reduced
    from repro_torch.dist.serve_selftest import expected_census

    cfg = get_reduced("llama3.2-1b")
    tp = dataclasses.make_dataclass("TP", ["attn_axes", "mlp_axes", "vocab_axes",
                                           "hd_axes"])
    assert expected_census(cfg, tp(("tp",), ("tp",), ("tp",), ()), None) == census("tp2")
    assert expected_census(cfg, tp(("sp",), ("sp",), ("sp",), ("sp",)), None) == census("sp2")
    assert expected_census(cfg, None, object()) == census("sequence")
    assert expected_census(cfg, None, None) == census("batch")
