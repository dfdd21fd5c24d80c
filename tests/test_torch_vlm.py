"""The VLM family (internvl2-2b: an LM backbone whose frontend is a stub,
precomputed patch embeddings prepended to the text tokens) in the port
against the JAX package, reduced in float32 (see ``_family_parity.py``
for the sizes and tolerances): the trunk's hidden states, ``Model.loss``
(over the text positions only), ``prefill`` and decode steps on the
plain and the flash routes, the trace's patch embeddings, and the paged
serving path (prompt and patches in the slot's pages) against
``SequentialOracle`` and the dense mode.
"""
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)
from _family_parity import (
    N_PATCHES,
    check_engines_match_the_jax_oracle,
    check_forward,
    check_loss,
    check_paged_step_matches_dense,
    check_prefill_decode,
    models,
    traces,
)
from _jax_draws import JaxDraws

from repro_torch.configs import get_config
from repro_torch.models import Family, build_model
from repro_torch.serve import EngineConfig, SequentialOracle, TraceConfig, make_trace, paged

ARCH = "internvl2-2b"


@pytest.fixture(scope="module")
def setup():
    return models(ARCH)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_hidden_matches_jax(impl):
    check_forward(ARCH, impl)


@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "loss_mask"])
def test_loss_matches_jax(with_mask):
    check_loss(ARCH, with_mask)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_decode_match_jax(impl):
    check_prefill_decode(ARCH, impl)


def test_engines_match_the_jax_oracle(setup):
    check_engines_match_the_jax_oracle(setup)


def test_paged_step_matches_dense(setup):
    check_paged_step_matches_dense(setup)


def test_trace_carries_the_jax_patch_embeddings(setup):
    """``make_trace`` on the JAX package's draws (``serve.patches`` is the
    split's fourth key) reproduces the JAX trace, patch embeddings
    included; on the port's draws it is seeded, and a trace without
    patches is refused by the engine."""
    jcfg, *_ , tcfg, tm, tp = setup
    jt, _ = traces(jcfg)
    tc = TraceConfig(n_requests=8, rate_per_s=400.0, slo_ms=8000.0, prompt_len=8,
                     min_gen=1, max_gen=6)
    got = make_trace(JaxDraws(3), tc, tcfg, n_patches=N_PATCHES)
    np.testing.assert_array_equal(got.prompts, np.asarray(jt.prompts))
    np.testing.assert_array_equal(got.patch_embeds, np.asarray(jt.patch_embeds, np.float32))
    a, b = (make_trace(JaxDraws(0), tc, tcfg), make_trace(JaxDraws(0), tc, tcfg))
    assert a.patch_embeds.shape == (8, 8, tcfg.d_model)
    np.testing.assert_array_equal(a.patch_embeds, b.patch_embeds)
    no_patches = make_trace(JaxDraws(3), tc, None)
    assert no_patches.patch_embeds is None
    ecfg = EngineConfig(slots=3, page_size=4, prompt_len=8, max_gen=6, max_requests=16)
    with pytest.raises(ValueError, match="patch_embeds"):
        SequentialOracle(tm, tp, ecfg).serve(no_patches)


def test_plan_counts_the_patches():
    cfg = get_config(ARCH)
    plan = paged.PagePlan.build(cfg, 128, 32)
    assert plan.n_patches == 8 and plan.prompt_eff == 136 and plan.prompt_pages == 9
    llama = paged.PagePlan.build(get_config("llama3.2-1b"), 128, 32)
    assert llama.n_patches == 0 and llama.prompt_eff == 128
    assert cfg.family is Family.VLM and build_model(cfg).param_count() == 1_889_634_304


def test_launcher_serves_internvl2_on_the_cpu():
    from repro_torch.launch import serve as launch

    rep = launch.main(["--arch", ARCH, "--device", "cpu", "--scale", "tiny",
                       "--engine", "continuous", "--attn", "paged", "--flash",
                       "--requests", "4", "--gen", "4", "--prompt-len", "8",
                       "--page-size", "4"])
    assert rep.completed == 4 and rep.rejected == 0
    out = launch.main(["--arch", ARCH, "--device", "cpu", "--scale", "tiny",
                       "--prompt-len", "8", "--gen", "3", "--flash"])
    assert tuple(out.shape) == (4, 3) and bool((out >= 0).all())
    assert isinstance(out, torch.Tensor)
