"""Shared checks of the HYBRID (hymba-1.5b), VLM (internvl2-2b) and ENCDEC
(seamless-m4t-medium) families against the JAX package
(``tests/test_torch_hybrid.py``, ``_vlm.py``, ``_encdec.py``).

Each family runs reduced (2 layers, d 64, 4 heads over 2, hd 16, vocab
256; hymba's SSM state 8 and dt rank 8; seamless's 2 encoder layers) in
float32, with the JAX parameters carried across by
``convert.model_params_from_jax`` and inputs made from a numpy seed. The
JAX model runs with ``scan_layers=False`` (ROADMAP.md R5: the JAX flash
route fails under the layer scan); its flash route runs the Pallas
kernel in interpret mode, the port's the plain K5. The JAX calls run
under ``jax.jit`` (one compile each, where op-by-op dispatch of the
unrolled layers took several times as long), and each (arch, route,
override) builds its models once per worker.

Tolerances: ``MODEL_TOL`` (2e-5 absolute + 1e-4 relative, as
``tests/test_torch_models.py`` holds the dense model: XLA and ATen order
their float32 sums differently, a few ulps per layer) for hidden states,
logits, losses and every cache leaf (KV, hymba's SSM and conv states,
seamless's cross K / V).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models import encdec as jed
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.models import Family, build_model
from repro_torch.models import encdec as ted
from repro_torch.models import transformer as ttf

F32 = dict(param_dtype="float32", compute_dtype="float32")
MODEL_TOL = dict(rtol=1e-4, atol=2e-5)
N_PATCHES, S_SRC = 3, 7


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def models(arch: str, impl: str = "xla", **over):
    """(jcfg, jm, jp, tcfg, tm, tp) of the reduced ``arch`` in float32."""
    return _models(arch, impl, tuple(sorted(over.items())))


@functools.cache
def _models(arch: str, impl: str, over: tuple):
    jcfg = jax_reduced(arch, scan_layers=False, attn_impl=impl, **F32, **dict(over))
    tcfg = get_reduced(arch, attn_impl=impl, **F32, **dict(over))
    jm = jax_build(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = convert.model_params_from_jax(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jm, jp, tcfg, build_model(tcfg), tp


def batch(cfg, b: int, s: int, seed: int) -> dict:
    """A numpy batch of ``cfg``'s family: tokens (b, s) and, for VLM, patch
    embeddings (b, N_PATCHES, d); for ENCDEC, frames (b, S_SRC, d)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family is Family.VLM:
        out["patch_embeds"] = rng.standard_normal((b, N_PATCHES, cfg.d_model)).astype(np.float32)
    if cfg.family is Family.ENCDEC:
        out["frames"] = rng.standard_normal((b, S_SRC, cfg.d_model)).astype(np.float32)
    return out


def to_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b: dict) -> dict:
    out = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    out["tokens"] = out["tokens"].long()
    return out


def check_forward(arch: str, impl: str, **over):
    """The trunk's hidden states (HYBRID / VLM: ``forward_hidden``;
    ENCDEC: ``encode`` and the teacher-forced ``decode_train``). ``over``
    overrides fields of the reduced config."""
    jcfg, jm, jp, tcfg, tm, tp = models(arch, impl, **over)
    b = batch(tcfg, 2, 9, seed=1)
    jb, tb = to_jax(b), to_torch(b)
    with torch.no_grad():
        if tcfg.family is Family.ENCDEC:
            jenc = jax.jit(lambda p, f: jed.encode(p, jcfg, f))(jp, jb["frames"])
            tenc = ted.encode(tp, tcfg, tb["frames"])
            np.testing.assert_allclose(_np(tenc), np.asarray(jenc), **MODEL_TOL)
            ref = jax.jit(lambda p, t, e: jed.decode_train(p, jcfg, t, e))(jp, jb["tokens"], jenc)
            got = ted.decode_train(tp, tcfg, tb["tokens"], tenc)
        else:
            ref = jax.jit(lambda p, t, e: jtf.forward_hidden(p, jcfg, tokens=t, embeds=e))(
                jp, jb["tokens"], jb.get("patch_embeds"))
            got = ttf.forward_hidden(tp, tcfg, tokens=tb["tokens"], embeds=tb.get("patch_embeds"))
    s_eff = 9 + (N_PATCHES if tcfg.family is Family.VLM else 0)
    assert tuple(got.shape) == (2, s_eff, tcfg.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(ref), **MODEL_TOL)


def check_loss(arch: str, with_mask: bool, **over):
    """``Model.loss`` on a (B, S+1) batch (and an optional loss mask)."""
    jcfg, jm, jp, tcfg, tm, tp = models(arch, **over)
    b = batch(tcfg, 3, 10, seed=2)
    if with_mask:
        b["loss_mask"] = (np.random.default_rng(3).random((3, 9)) < 0.6).astype(np.float32)
    ref = float(jax.jit(jm.loss)(jp, to_jax(b)))
    with torch.no_grad():
        got = tm.loss(tp, to_torch(b))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), ref, **MODEL_TOL)


def check_prefill_decode(arch: str, impl: str, steps: int = 3, prompt: int = 6,
                         cache_len: int = 16, **over):
    """``prefill`` then ``steps`` greedy ``decode_step``s: the logits after
    each, and every cache leaf after the prefill and after the last step.
    ``over`` overrides fields of the reduced config."""
    jcfg, jm, jp, tcfg, tm, tp = models(arch, impl, **over)
    b = batch(tcfg, 2, prompt, seed=4)
    jl, jc = jax.jit(jm.prefill, static_argnames="cache_len")(jp, to_jax(b),
                                                              cache_len=cache_len)
    jstep = jax.jit(jm.decode_step)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, to_torch(b), cache_len=cache_len)

    def hold(jc, tc, when):
        assert set(tc) == set(jc), (sorted(tc), sorted(jc))
        assert tc["pos"] == int(jc["pos"]), when
        for key in jc:
            if key != "pos":
                np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]),
                                           err_msg=f"{when} {key}", **MODEL_TOL)

    np.testing.assert_allclose(_np(tl), np.asarray(jl), **MODEL_TOL)
    hold(jc, tc, "prefill")
    tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
    for i in range(steps):
        jl, jc = jstep(jp, jc, jnp.asarray(tok))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok).long())
        np.testing.assert_allclose(_np(tl), np.asarray(jl), err_msg=f"step {i}", **MODEL_TOL)
        tok = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
    hold(jc, tc, f"after {steps} steps")


# --------------------------------------------------------------------- #
# Serving (HYBRID and VLM): the continuous engine against the oracles
# --------------------------------------------------------------------- #
ECFG = dict(slots=3, page_size=4, prompt_len=8, max_gen=6, max_requests=16, n_patches=N_PATCHES)
TRACE = dict(n_requests=8, rate_per_s=400.0, slo_ms=8000.0, prompt_len=8, min_gen=1,
             max_gen=6)


def traces(jcfg, seed: int = 3, **kw):
    """The JAX package's seeded trace and the same trace in the port."""
    from repro.serve import TraceConfig as JaxTraceConfig
    from repro.serve import make_trace as jax_make_trace
    from repro_torch.serve import trace_from_arrays

    jt = jax_make_trace(jax.random.PRNGKey(seed), JaxTraceConfig(**dict(TRACE, **kw)), jcfg,
                        n_patches=N_PATCHES)
    return jt, trace_from_arrays(jt.arrival_ms, jt.gen_len, jt.prompts, jt.slo_ms,
                                 jt.patch_embeds)


def check_engines_match_the_jax_oracle(setup):
    """The port's oracle and its dense-mode engine equal the JAX package's
    ``SequentialOracle`` token for token (the oracle in the §IV.F
    accounting too, to float64 rounding); the paged engine serves the
    dense engine's tokens; slots are conserved. (Not the JAX continuous
    engine: ROADMAP.md R2.)"""
    from repro.serve import EngineConfig as JaxEngineConfig
    from repro.serve import SequentialOracle as JaxOracle
    from repro_torch.serve import ContinuousBatchingEngine, EngineConfig, SequentialOracle

    jcfg, jm, jp, tcfg, tm, tp = setup
    jt, tt = traces(jcfg)
    ref = JaxOracle(jm, jp, JaxEngineConfig(**ECFG)).serve(jt)
    oracle = SequentialOracle(tm, tp, EngineConfig(**ECFG)).serve(tt)
    dense = ContinuousBatchingEngine(tm, tp, EngineConfig(**ECFG)).serve(tt)
    paged = ContinuousBatchingEngine(tm, tp, EngineConfig(**ECFG, attn="paged")).serve(tt)
    for rep in (oracle, dense, paged):
        assert rep.completed == tt.n_requests and rep.rejected == 0
    c = paged.counters
    assert c["arrived"] == c["completed"] + c["rejected"] + c["in_flight"] + c["waiting"]
    for req in range(tt.n_requests):
        assert oracle.tokens_for(req) == ref.tokens_for(req), req
        assert dense.tokens_for(req) == ref.tokens_for(req), req
        assert paged.tokens_for(req) == dense.tokens_for(req), req
    for k in ("decode_steps", "cold_starts", "tokens_generated", "slo_violations"):
        assert getattr(oracle, k) == getattr(ref, k), k
    for k in ("virtual_ms", "energy_j"):
        np.testing.assert_allclose(getattr(oracle, k), getattr(ref, k), rtol=1e-12)
    assert dense.virtual_ms <= oracle.virtual_ms + 1e-6


def check_paged_step_matches_dense(setup):
    """Three slots admitted (one then marked inactive), one decode step in
    the dense mode and paged on copies of one pool: logits within 1e-5
    (float32; the two attentions order their sums differently), and
    HYBRID's active slots' SSM and conv states too (the branch is the same
    in both modes; from the second layer on, its input carries the
    attentions' difference; an inactive slot's attention differs between
    the modes and its state is overwritten at its next admission)."""
    from repro_torch.models import Runtime
    from repro_torch.serve import paged

    jcfg, jm, jp, tcfg, tm, tp = setup
    plan = paged.PagePlan.build(tcfg, 8, 6, page_size=4, n_patches=N_PATCHES)
    assert plan.prompt_eff == 8 + (N_PATCHES if tcfg.family is Family.VLM else 0)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, 256, (3, 8)))
    embeds = torch.from_numpy(rng.standard_normal((3, N_PATCHES, 64)).astype(np.float32))
    pool = paged.init_pool(tcfg, plan, 3, 3 * plan.pages_per_slot, device="cpu")
    tokens = torch.zeros((3, 1), dtype=torch.int64)
    out_buf = torch.zeros((4, plan.max_gen), dtype=torch.int32)
    admit = paged.make_admit_fn(tm, plan)
    n = plan.pages_per_slot
    table = torch.arange(1, 3 * n + 1, dtype=torch.int32).reshape(3, n)
    for s in range(3):
        extra = [embeds[s:s + 1]] if tcfg.family is Family.VLM else []
        admit(tp, pool, tokens, out_buf, prompts[s:s + 1], *extra,
              table[s, :plan.prompt_pages].long(), s, s)
    positions = torch.tensor([plan.prompt_eff] * 2 + [0])
    active = torch.tensor([True, True, False])
    out, pools = {}, {}
    for mode in ("dense", "paged"):
        pools[mode] = {k: v.clone() for k, v in pool.items()}
        out[mode], _ = paged._paged_transformer_step(
            tp, tcfg, plan, pools[mode], tokens, table, positions, active, Runtime(), mode)
    np.testing.assert_allclose(out["paged"][:2].numpy(), out["dense"][:2].numpy(),
                               rtol=0, atol=1e-5)
    for key in pool:
        if key not in ("k", "v"):
            np.testing.assert_allclose(pools["paged"][key][:, :2].numpy(),
                                       pools["dense"][key][:, :2].numpy(), rtol=0, atol=1e-5,
                                       err_msg=key)
