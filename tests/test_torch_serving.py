"""The port's serving path (``repro_torch.serve``) on the reduced
llama3.2-1b in float32, with the JAX parameters carried across.

  * the port's engine in ``dense`` mode equals the JAX package's
    ``SequentialOracle`` token for token on the JAX package's own seeded
    trace, and the port's oracle equals it in tokens and in the §IV.F
    accounting (virtual time, energy, cold starts) to float64 rounding;
  * ``paged`` mode's first-decode-step logits are within 1e-5 of
    ``dense`` (float32: the two attentions order their sums differently),
    and its engine serves the trace to the same tokens;
  * slot conservation under rejection, finishing at prefill, the page
    allocator's round trip, the event queue against the JAX queue, and
    the launcher on the CPU.

No test here runs the JAX ``ContinuousBatchingEngine``: its outcome
changes from run to run (ROADMAP.md R2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.serve import EngineConfig as JaxEngineConfig
from repro.serve import SequentialOracle as JaxOracle
from repro.serve import TraceConfig as JaxTraceConfig
from repro.serve import make_trace as jax_make_trace
from repro.sim.events import queue as jq
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.models import Runtime, build_model
from repro_torch.random import TorchDraws
from repro_torch.serve import (ContinuousBatchingEngine, EngineConfig, PageAllocator,
                               SequentialOracle, TraceConfig, make_trace, paged,
                               trace_from_arrays)
from repro_torch.sim.events import queue as tq

F32 = dict(param_dtype="float32", compute_dtype="float32")
ECFG = dict(slots=3, page_size=4, prompt_len=8, max_gen=6, max_requests=16)
TRACE = dict(n_requests=8, rate_per_s=400.0, slo_ms=8000.0, prompt_len=8, min_gen=1,
             max_gen=6)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_reduced("llama3.2-1b", loss_chunk=0, **F32)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_reduced("llama3.2-1b", **F32)
    tp = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


def _traces(jcfg, seed=3, **kw):
    jt = jax_make_trace(jax.random.PRNGKey(seed), JaxTraceConfig(**dict(TRACE, **kw)), jcfg)
    return jt, trace_from_arrays(jt.arrival_ms, jt.gen_len, jt.prompts, jt.slo_ms)


def test_dense_engine_and_oracle_match_the_jax_oracle(setup):
    jcfg, jm, jp, tcfg, tm, tp = setup
    jt, tt = _traces(jcfg)
    ref = JaxOracle(jm, jp, JaxEngineConfig(**ECFG)).serve(jt)
    oracle = SequentialOracle(tm, tp, EngineConfig(**ECFG)).serve(tt)
    rep = ContinuousBatchingEngine(tm, tp, EngineConfig(**ECFG)).serve(tt)
    assert rep.completed == oracle.completed == ref.completed == tt.n_requests
    for req in range(tt.n_requests):
        assert oracle.tokens_for(req) == ref.tokens_for(req), req
        assert rep.tokens_for(req) == ref.tokens_for(req), req
    for k in ("decode_steps", "cold_starts", "tokens_generated", "slo_violations"):
        assert getattr(oracle, k) == getattr(ref, k), k
    for k in ("virtual_ms", "energy_j"):
        np.testing.assert_allclose(getattr(oracle, k), getattr(ref, k), rtol=1e-12)
    np.testing.assert_allclose(oracle.latency_ms, ref.latency_ms, rtol=1e-12)
    # batching never costs virtual time against one-at-a-time
    assert rep.virtual_ms <= oracle.virtual_ms + 1e-6
    assert np.isfinite(rep.latency_ms).all()


def _admitted_pool(tm, tp, plan, prompts, slots, num_pages):
    pool = paged.init_pool(tm.cfg, plan, slots, num_pages, device="cpu")
    tokens = torch.zeros((slots, 1), dtype=torch.int64)
    out_buf = torch.zeros((slots + 1, plan.max_gen), dtype=torch.int32)
    admit = paged.make_admit_fn(tm, plan)
    n = plan.pages_per_slot
    table = torch.arange(1, slots * n + 1, dtype=torch.int32).reshape(slots, n)
    for s in range(slots):
        admit(tp, pool, tokens, out_buf, prompts[s:s + 1],
              table[s, :plan.prompt_pages].long(), s, s)
    return pool, tokens, out_buf, table


@pytest.mark.parametrize("window", [-1, 3])
def test_paged_step_logits_match_dense(setup, window):
    """One decode step over three admitted slots (one of them inactive),
    dense gather vs the paged path, on copies of one pool."""
    *_, tm, tp = setup
    cfg = dataclasses.replace(tm.cfg, window_pattern=(window,))
    model = build_model(cfg)
    plan = paged.PagePlan.build(cfg, 8, 6, page_size=4)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 8)))
    pool, tokens, _, table = _admitted_pool(model, tp, plan, prompts, 3, 3 * plan.pages_per_slot)
    positions = torch.tensor([8, 8, 0])
    active = torch.tensor([True, True, False])
    out = {}
    for mode in ("dense", "paged"):
        out[mode], _ = paged._paged_transformer_step(
            tp, cfg, plan, {k: v.clone() for k, v in pool.items()}, tokens, table,
            positions, active, Runtime(), mode)
    np.testing.assert_allclose(out["paged"][:2].numpy(), out["dense"][:2].numpy(),
                               rtol=0, atol=1e-5)


def test_paged_engine_serves_the_dense_tokens(setup):
    jcfg, jm, jp, tcfg, tm, tp = setup
    _, tt = _traces(jcfg)
    dense = ContinuousBatchingEngine(tm, tp, EngineConfig(**ECFG)).serve(tt)
    rep = ContinuousBatchingEngine(tm, tp, EngineConfig(**ECFG, attn="paged")).serve(tt)
    assert rep.completed == tt.n_requests
    assert rep.counters["arrived"] == rep.completed + rep.rejected
    for req in range(tt.n_requests):
        assert rep.tokens_for(req) == dense.tokens_for(req), req
    toks = rep.tokens[: tt.n_requests]
    assert ((toks >= 0) & (toks < tcfg.vocab_size)).all()


def test_slot_conservation_under_rejection(setup):
    jcfg, jm, jp, tcfg, tm, tp = setup
    ecfg = EngineConfig(**dict(ECFG, slots=2, max_queue=1, policy="edf"))
    _, tt = _traces(jcfg, n_requests=12, rate_per_s=5000.0)
    rep = ContinuousBatchingEngine(tm, tp, ecfg).serve(tt)
    assert rep.rejected > 0
    c = rep.counters
    assert c["arrived"] == tt.n_requests == rep.completed + rep.rejected
    ref = SequentialOracle(tm, tp, ecfg).serve(tt)
    done = np.nonzero(~np.isnan(rep.latency_ms))[0]
    assert done.size == rep.completed
    for req in done:
        assert rep.tokens_for(int(req)) == ref.tokens_for(int(req))


def test_gen_len_one_finishes_at_prefill(setup):
    jcfg, jm, jp, tcfg, tm, tp = setup
    _, tt = _traces(jcfg, min_gen=1, max_gen=1)
    rep = ContinuousBatchingEngine(tm, tp, EngineConfig(**ECFG)).serve(tt)
    ref = SequentialOracle(tm, tp, EngineConfig(**ECFG)).serve(tt)
    assert rep.completed == tt.n_requests and rep.decode_steps == 0
    for req in range(tt.n_requests):
        assert rep.tokens_for(req) == ref.tokens_for(req)


def test_page_allocator_roundtrip():
    alloc = PageAllocator(6)
    a = alloc.alloc(4)
    assert a is not None and len(set(a)) == 4 and 0 not in a
    assert alloc.alloc(3) is None  # only 2 left: all or nothing
    b = alloc.alloc(2)
    assert b is not None and not (set(a) & set(b))
    alloc.free(a)
    alloc.free(b)
    assert sorted(alloc.alloc(6)) == [1, 2, 3, 4, 5, 6]  # everything came back
    with pytest.raises(AssertionError):
        alloc.free([0])  # the trash page is never handed out


def test_event_queue_matches_jax():
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 10, 6).astype(np.float32)
    t[4] = t[1]  # a tie: the lower slot pops first
    mask = np.array([1, 1, 0, 1, 1, 1], bool)
    args = (t, np.arange(6), np.full(6, tq.KIND_ARRIVE), np.arange(6.0), mask)
    jqu = jq.push_events(jq.make_queue(5), *map(jnp.asarray, args))
    tqu = tq.push_events(tq.make_queue(5), *map(torch.as_tensor, args))
    for name in tq.EventQueue._fields:
        np.testing.assert_array_equal(getattr(tqu, name).numpy(),
                                      np.asarray(getattr(jqu, name)), err_msg=name)
    for _ in range(6):
        assert float(tq.peek_time(tqu)) == float(jq.peek_time(jqu))
        tev, tqu = tq.pop_event(tqu)
        jev, jqu = jq.pop_event(jqu)
        for name in tq.Event._fields:
            assert getattr(tev, name).item() == np.asarray(getattr(jev, name)).item(), name


def test_make_trace_is_seeded_and_in_range():
    cfg = get_reduced("llama3.2-1b")
    tc = TraceConfig(n_requests=20, prompt_len=8, min_gen=2, max_gen=5)
    a, b = (make_trace(TorchDraws(7, "cpu"), tc, cfg) for _ in range(2))
    np.testing.assert_array_equal(a.prompts, b.prompts)
    np.testing.assert_array_equal(a.arrival_ms, b.arrival_ms)
    assert (np.diff(a.arrival_ms) >= 0).all() and a.arrival_ms[0] > 0
    assert a.gen_len.min() >= 2 and a.gen_len.max() <= 5
    assert a.prompts.shape == (20, 8) and a.prompts.max() < cfg.vocab_size
    assert int(a.queue.valid.sum()) == 20


def test_launcher_serves_on_the_cpu_and_refuses_the_mesh_options():
    """One device, then the mesh options on CPU worlds: ``--devices 2
    --reduced`` serves the same tokens batch-parallel and (batch 1)
    sequence-parallel as one device does, the continuous engine on each
    data replica, and ``--multi-pod`` on 4 ranks (pod 2 x zero 2); MoE
    under rules and ``--devices`` without ``--scale full`` are refused."""
    from repro_torch.launch import serve as launch

    rep = launch.main(["--device", "cpu", "--engine", "continuous",
                       "--attn", "paged", "--flash", "--requests", "4", "--gen", "4",
                       "--prompt-len", "8", "--page-size", "4"])
    assert rep.completed == 4
    out = launch.main(["--device", "cpu", "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (4, 3)
    one = launch.main(["--device", "cpu", "--prompt-len", "8", "--gen", "3", "--batch", "1"])
    mesh = ["--scale", "full", "--reduced", "--device", "cpu", "--prompt-len", "8",
            "--gen", "3"]
    assert torch.equal(launch.main(mesh + ["--devices", "2"]), out)
    assert torch.equal(launch.main(mesh + ["--devices", "2", "--batch", "1"]), one)
    assert torch.equal(launch.main(mesh + ["--devices", "4", "--multi-pod"]), out)
    cont = launch.main(mesh + ["--devices", "2", "--engine", "continuous", "--attn", "paged",
                               "--requests", "4", "--page-size", "4"])
    assert cont.completed == 4
    with pytest.raises(NotImplementedError, match="item 11"):
        launch.main(mesh + ["--devices", "2", "--arch", "moonshot-v1-16b-a3b"])
    for flag in (["--devices", "8"], ["--multi-pod"], ["--reduced"]):
        with pytest.raises(ValueError, match="--scale full"):
            launch.main(["--device", "cpu", *flag])


def test_device_state_defaults_to_the_card():
    """Without a device the pool and the cache go to CUDA: here, with no
    card, that raises instead of silently landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the card is present: nothing to refuse")
    cfg = get_reduced("llama3.2-1b")
    plan = paged.PagePlan.build(cfg, 8, 6, page_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paged.init_pool(cfg, plan, 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg).init_cache(1, 8)
    assert build_model(cfg).init_cache(1, 8, device="cpu")["k"].device.type == "cpu"


# --------------------------------------------------------------------- #
# rwkv6 (the SSM family): the slot-indexed recurrent state, prefill
# through K6's entry point (its plain version on the CPU)
# --------------------------------------------------------------------- #
RWKV = dict(d_model=128, **F32)  # two wkv heads of 64


@pytest.fixture(scope="module")
def rwkv():
    jcfg = jax_reduced("rwkv6-1.6b", loss_chunk=0, **RWKV)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_reduced("rwkv6-1.6b", **RWKV)
    tp = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


def test_rwkv6_engine_and_oracle_match_the_jax_oracle(rwkv):
    """The engine's tokens equal the port's oracle's, which equal the JAX
    SequentialOracle's, with the same §IV.F accounting."""
    jcfg, jm, jp, tcfg, tm, tp = rwkv
    jt, tt = _traces(jcfg)
    ref = JaxOracle(jm, jp, JaxEngineConfig(**ECFG)).serve(jt)
    oracle = SequentialOracle(tm, tp, EngineConfig(**ECFG)).serve(tt)
    rep = ContinuousBatchingEngine(tm, tp, EngineConfig(**ECFG)).serve(tt)
    assert rep.completed == oracle.completed == ref.completed == tt.n_requests
    for req in range(tt.n_requests):
        assert oracle.tokens_for(req) == ref.tokens_for(req), req
        assert rep.tokens_for(req) == oracle.tokens_for(req), req
    for k in ("decode_steps", "cold_starts", "tokens_generated", "slo_violations"):
        assert getattr(oracle, k) == getattr(ref, k), k
    np.testing.assert_allclose(oracle.virtual_ms, ref.virtual_ms, rtol=1e-12)
    np.testing.assert_allclose(oracle.energy_j, ref.energy_j, rtol=1e-12)
    assert rep.virtual_ms <= oracle.virtual_ms + 1e-6
    toks = rep.tokens[: tt.n_requests]
    assert ((toks >= 0) & (toks < tcfg.vocab_size)).all()


def test_rwkv6_slot_conservation_under_rejection(rwkv):
    jcfg, jm, jp, tcfg, tm, tp = rwkv
    ecfg = EngineConfig(**dict(ECFG, slots=2, max_queue=1, policy="edf"))
    _, tt = _traces(jcfg, n_requests=12, rate_per_s=5000.0)
    rep = ContinuousBatchingEngine(tm, tp, ecfg).serve(tt)
    assert rep.rejected > 0
    c = rep.counters
    assert c["arrived"] == tt.n_requests == rep.completed + rep.rejected
    assert c["in_flight"] == c["waiting"] == 0
    ref = SequentialOracle(tm, tp, ecfg).serve(tt)
    done = np.nonzero(~np.isnan(rep.latency_ms))[0]
    assert done.size == rep.completed
    for req in done:
        assert rep.tokens_for(int(req)) == ref.tokens_for(int(req))


def test_rwkv6_admission_writes_the_prefill_state_into_its_slot(rwkv):
    """The pool is the slot-indexed state (no pages, no pos); admission
    writes the prefill's state into its slot and leaves the others."""
    *_, tcfg, tm, tp = rwkv
    plan = paged.PagePlan.build(tcfg, 8, 6, page_size=4)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 8)))
    pool, tokens, out_buf, _ = _admitted_pool(tm, tp, plan, prompts, 3, 3 * plan.pages_per_slot)
    assert set(pool) == {"wkv", "tm_x", "cm_x"}
    assert tuple(pool["wkv"].shape) == (tcfg.num_layers, 3, 2, 64, 64)
    with torch.no_grad():
        logits, cache = tm.prefill(tp, {"tokens": prompts[1:2]}, cache_len=0)
    for key in pool:
        torch.testing.assert_close(pool[key][:, 1], cache[key][:, 0], rtol=0, atol=0)
    assert int(tokens[1, 0]) == int(torch.argmax(logits[0, -1])) == int(out_buf[1, 0])


def test_launcher_serves_rwkv6_on_the_cpu():
    from repro_torch.launch import serve as launch

    rep = launch.main(["--arch", "rwkv6-1.6b", "--device", "cpu", "--scale", "tiny",
                       "--engine", "continuous", "--requests", "4", "--gen", "4",
                       "--prompt-len", "8", "--page-size", "4"])
    assert rep.completed == 4 and rep.rejected == 0
    out = launch.main(["--arch", "rwkv6-1.6b", "--device", "cpu", "--scale", "tiny",
                       "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (4, 3)


def test_unported_families_do_not_serve():
    """HYBRID serves now (its plan and its pool, with the slot-indexed SSM
    and conv states); ENCDEC keeps raising, as in the JAX package."""
    from repro_torch.models import Family

    cfg = get_reduced("llama3.2-1b")
    hybrid = dataclasses.replace(cfg, family=Family.HYBRID, ssm_state=8)
    plan = paged.PagePlan.build(hybrid, 8, 6)
    assert plan.n_patches == 0 and plan.prompt_eff == 8
    pool = paged.init_pool(hybrid, plan, 3, 6, device="cpu")
    assert tuple(pool["ssm_state"].shape) == (2, 3, 64, 8)
    assert tuple(pool["conv_state"].shape) == (2, 3, 3, 64)
    encdec = dataclasses.replace(cfg, family=Family.ENCDEC, num_encoder_layers=2)
    with pytest.raises(NotImplementedError, match="ENCDEC"):
        paged.PagePlan.build(encdec, 8, 6)


# --------------------------------------------------------------------- #
# moonshot-v1-16b-a3b (the MOE family): the served FFN is the dropless
# route of models/moe.py, in every admission and decode step
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def moe():
    jcfg = jax_reduced("moonshot-v1-16b-a3b", loss_chunk=0, **F32)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = get_reduced("moonshot-v1-16b-a3b", **F32)
    tp = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


def test_moe_engine_and_oracle_match_the_jax_oracle(moe):
    """The dense-mode engine equals the port's oracle and the JAX
    SequentialOracle token for token; the paged engine serves the same
    tokens."""
    jcfg, jm, jp, tcfg, tm, tp = moe
    jt, tt = _traces(jcfg)
    ref = JaxOracle(jm, jp, JaxEngineConfig(**ECFG)).serve(jt)
    oracle = SequentialOracle(tm, tp, EngineConfig(**ECFG)).serve(tt)
    rep = ContinuousBatchingEngine(tm, tp, EngineConfig(**ECFG)).serve(tt)
    paged_rep = ContinuousBatchingEngine(tm, tp, EngineConfig(**ECFG, attn="paged")).serve(tt)
    assert rep.completed == paged_rep.completed == oracle.completed == tt.n_requests
    for req in range(tt.n_requests):
        assert oracle.tokens_for(req) == ref.tokens_for(req), req
        assert rep.tokens_for(req) == oracle.tokens_for(req), req
        assert paged_rep.tokens_for(req) == rep.tokens_for(req), req
    np.testing.assert_allclose(oracle.virtual_ms, ref.virtual_ms, rtol=1e-12)
    assert rep.virtual_ms <= oracle.virtual_ms + 1e-6


def test_moe_slot_conservation_under_rejection(moe):
    jcfg, jm, jp, tcfg, tm, tp = moe
    ecfg = EngineConfig(**dict(ECFG, slots=2, max_queue=1, policy="edf"))
    _, tt = _traces(jcfg, n_requests=12, rate_per_s=5000.0)
    rep = ContinuousBatchingEngine(tm, tp, ecfg).serve(tt)
    assert rep.rejected > 0
    c = rep.counters
    assert c["arrived"] == tt.n_requests == rep.completed + rep.rejected
    assert c["in_flight"] == c["waiting"] == 0
    ref = SequentialOracle(tm, tp, ecfg).serve(tt)
    for req in np.nonzero(~np.isnan(rep.latency_ms))[0]:
        assert rep.tokens_for(int(req)) == ref.tokens_for(int(req))
