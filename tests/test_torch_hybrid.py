"""The HYBRID family (hymba-1.5b: attention and a Mamba-style SSM branch
in every layer, averaged) in the port against the JAX package, reduced
in float32 (see ``_family_parity.py`` for the sizes and tolerances):
the trunk's hidden states, ``Model.loss``, ``prefill`` and decode steps
(logits, KV, SSM and conv states) on the plain and the flash routes, and
the paged serving path against ``SequentialOracle`` and the dense mode.
"""
import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)
from _family_parity import (
    MODEL_TOL,
    check_engines_match_the_jax_oracle,
    check_forward,
    check_loss,
    check_paged_step_matches_dense,
    check_prefill_decode,
    models,
)

from repro_torch.configs import get_config
from repro_torch.models import GLOBAL, Family, build_model
from repro_torch.models import transformer as ttf

ARCH = "hymba-1.5b"
# hymba's pattern reduced: a global layer and a local one, its window cut
# to 4 so that the 9-token prompts, decode steps and 8-token serving
# prompts cross it (the default reduced window of 32 would not)
OVER = dict(window_pattern=(GLOBAL, 4))


@pytest.fixture(scope="module")
def setup():
    return models(ARCH, **OVER)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_forward_hidden_matches_jax(impl):
    check_forward(ARCH, impl, **OVER)


@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "loss_mask"])
def test_loss_matches_jax(with_mask):
    check_loss(ARCH, with_mask, **OVER)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_decode_match_jax(impl):
    """Past the window in prefill (K5's plain version on the flash route)
    and in decode, beside the SSM branch."""
    check_prefill_decode(ARCH, impl, steps=4, prompt=9, **OVER)


def test_prefill_state_continues_as_decode(setup):
    """The SSM and conv states of a prefill of S tokens equal those of a
    prefill of S - 2 tokens followed by two decode steps of the last two."""
    *_, tcfg, tm, tp = setup
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 256, (2, 9)))
    with torch.no_grad():
        _, full = tm.prefill(tp, {"tokens": toks}, cache_len=12)
        _, part = tm.prefill(tp, {"tokens": toks[:, :7]}, cache_len=12)
        for i in (7, 8):
            _, part = tm.decode_step(tp, part, toks[:, i:i + 1])
    for key in ("ssm_state", "conv_state", "k", "v"):
        np.testing.assert_allclose(part[key].numpy(), full[key].numpy(), err_msg=key,
                                   **MODEL_TOL)


def test_engines_match_the_jax_oracle(setup):
    check_engines_match_the_jax_oracle(setup)


def test_paged_step_matches_dense(setup):
    check_paged_step_matches_dense(setup)


def test_full_config_and_its_declarations():
    """hymba-1.5b at full size: its shape, the SSM leaves' float32, the
    closed-form count against the declarations' (which add the padded
    vocab rows and ``ssm_norm``), and a cache with its SSM states."""
    cfg = get_config(ARCH)
    assert cfg.family is Family.HYBRID and cfg.dt_rank == 100 and cfg.d_inner == 1600
    assert cfg.layer_windows().count(GLOBAL) == 3 and cfg.layer_windows()[1] == 1024
    decls = ttf.param_decls(cfg)["layers"]
    assert decls["ssm_a_log"].dtype == "float32" and decls["ssm_d"].init == "ones"
    assert decls["ssm_xproj"].shape == (32, 1600, 100 + 32)
    model = build_model(cfg)
    pad_rows = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model * 2
    assert model.param_count() == cfg.param_count() + pad_rows + 32 * cfg.d_model
    assert model.param_count() == 1_403_752_000
    cache = build_model(cfg.reduced()).init_cache(3, 10, device="cpu")
    assert tuple(cache["ssm_state"].shape) == (2, 3, 64, 8)
    assert tuple(cache["conv_state"].shape) == (2, 3, 3, 64)
    assert cache["ssm_state"].dtype == torch.float32


def test_launcher_serves_hymba_on_the_cpu():
    from repro_torch.launch import serve as launch

    rep = launch.main(["--arch", ARCH, "--device", "cpu", "--scale", "tiny",
                       "--engine", "continuous", "--attn", "paged", "--flash",
                       "--requests", "4", "--gen", "4", "--prompt-len", "8",
                       "--page-size", "4"])
    assert rep.completed == 4 and rep.rejected == 0
    out = launch.main(["--arch", ARCH, "--device", "cpu", "--scale", "tiny",
                       "--prompt-len", "8", "--gen", "3", "--flash"])
    assert tuple(out.shape) == (4, 3)
