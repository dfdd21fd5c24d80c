"""The ENCDEC family (seamless-m4t-medium: a bidirectional encoder over
precomputed frames, a causal decoder with cross-attention) in the port
against the JAX package, reduced in float32 (see ``_family_parity.py``
for the sizes and tolerances): ``encode`` and the teacher-forced decoder,
``Model.loss``, ``prefill`` (self and cross caches) and decode steps on
the plain and the flash routes (K5's plain version on the encoder's
bidirectional self-attention, the decoder's causal one and the
cross-attention, Sq != Sk and Sq = 1); the static launcher; and the
continuous engine's refusal, as the JAX engine refuses.
"""
import dataclasses

import numpy as np
import pytest
import torch
from _threads import one_thread  # noqa: F401 (autouse)
from _family_parity import check_forward, check_loss, check_prefill_decode, models

from repro_torch.configs import get_config
from repro_torch.models import Family, build_model
from repro_torch.models import encdec as ted
from repro_torch.serve import ContinuousBatchingEngine, EngineConfig, paged

ARCH = "seamless-m4t-medium"


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_encode_and_decoder_match_jax(impl):
    check_forward(ARCH, impl)


@pytest.mark.parametrize("with_mask", [False, True], ids=["no_mask", "loss_mask"])
def test_loss_matches_jax(with_mask):
    check_loss(ARCH, with_mask)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_prefill_and_decode_match_jax(impl):
    check_prefill_decode(ARCH, impl)


def test_cross_attention_goes_through_k5(monkeypatch):
    """With ``attn_impl="flash"`` every attention of the prefill (the
    encoder's, the decoder's and the cross-attention) and the decode
    step's cross-attention call K5's entry point, bidirectional where it
    should be; the decoder's decode self-attention is the plain
    ``attention_decode``."""
    from repro_torch.kernels.flash_attention import ops

    *_, tcfg, tm, tp = models(ARCH, "flash")
    calls = []
    real = ops.flash_attention

    def counted(q, k, v, *a, bidirectional=False, **kw):
        calls.append((q.shape[1], k.shape[1], bidirectional))
        return real(q, k, v, *a, bidirectional=bidirectional, **kw)

    monkeypatch.setattr(ops, "flash_attention", counted)
    frames = torch.randn((2, 7, 64), generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 256, (2, 5), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, cache = tm.prefill(tp, {"tokens": tokens, "frames": frames}, cache_len=8)
        L, Le = tcfg.num_layers, tcfg.num_encoder_layers
        assert calls == [(7, 7, True)] * Le + [(5, 5, False), (5, 7, True)] * L
        calls.clear()
        tm.decode_step(tp, cache, torch.argmax(logits[:, -1], -1)[:, None])
    assert calls == [(1, 7, True)] * L and cache["pos"] == 6


def test_full_config_cache_and_refusals():
    """seamless-m4t-medium at full size builds (the declarations' count,
    cross-attention leaves included); its cache carries the cross K / V;
    the continuous engine refuses it, as the JAX engine does."""
    cfg = get_config(ARCH)
    model = build_model(cfg)
    assert cfg.family is Family.ENCDEC and model.param_count() == 977_860_608
    decls = ted.param_decls(cfg)
    assert set(decls) == {"embed", "enc_layers", "dec_layers", "enc_final_norm",
                          "final_norm", "lm_head"}
    assert decls["dec_layers"]["x_wq"].shape == (12, 1024, 16, 64)
    assert "x_wq" not in decls["enc_layers"]
    cache = build_model(cfg.reduced()).init_cache(3, 10, src_len=7, device="cpu")
    assert tuple(cache["xk"].shape) == (2, 3, 7, 2, 16) and cache["pos"] == 0
    assert tuple(cache["k"].shape) == (2, 3, 10, 2, 16)
    with pytest.raises(NotImplementedError, match="ENCDEC"):
        paged.PagePlan.build(cfg, 8, 6)
    tiny = cfg.reduced(param_dtype="float32", compute_dtype="float32")
    params = build_model(tiny).init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="ENCDEC"):
        ContinuousBatchingEngine(build_model(tiny), params, EngineConfig())


def test_flash_loss_raises():
    """K5 has no backward: a loss asked of the flash route raises."""
    *_, tcfg, tm, tp = models(ARCH, "flash")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int64), "frames": torch.zeros((1, 3, 64))}
    with pytest.raises(NotImplementedError, match="backward"):
        tm.loss(tp, batch)
    cfg = dataclasses.replace(tcfg, attn_impl="xla")
    assert np.isfinite(float(build_model(cfg).loss(tp, batch)))


def test_launcher_serves_seamless_statically_on_the_cpu():
    from repro_torch.launch import serve as launch

    out = launch.main(["--arch", ARCH, "--device", "cpu", "--scale", "tiny",
                       "--engine", "static", "--flash", "--prompt-len", "8", "--gen", "3",
                       "--batch", "2"])
    assert tuple(out.shape) == (2, 3) and bool(((out >= 0) & (out < 256)).all())
    with pytest.raises(NotImplementedError, match="ENCDEC"):
        launch.main(["--arch", ARCH, "--device", "cpu", "--scale", "tiny",
                     "--engine", "continuous", "--requests", "2"])
