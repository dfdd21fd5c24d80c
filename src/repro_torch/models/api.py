"""Uniform model interface over every architecture family (port of
``repro/models/api.py``).

``build_model(cfg)`` returns a ``Model`` whose methods close over the
config and dispatch on its family, as the JAX package's do:

    model.init(generator)                      -> params (on its device)
    model.loss(params, batch)                  -> scalar CE loss
    model.prefill(params, batch, cache_len)    -> (logits, cache)
    model.decode_step(params, cache, tokens)   -> (logits, cache)
    model.init_cache(batch, max_len, src_len=0, device=None, runtime=Runtime()) -> cache
    model.param_count() / active_param_count() / flops_per_token()

``batch`` keys by family (an optional ``loss_mask`` (B, S) beside them):

    dense / moe / hybrid / ssm: tokens (B, S+1), inputs and next-token
                                targets derived here
    vlm:    tokens (B, S_text+1), patch_embeds (B, S_img, d)
    encdec: frames (B, S_src, d), tokens (B, S_tgt+1)

Serving methods take a ``Runtime``: under mesh rules its ``tensor`` /
``sequence`` views run a DENSE model on one rank's share (its logits are
its vocabulary block, its cache its kv heads and span; pick tokens with
``transformer.greedy``); any other family under them raises, naming
ROADMAP item 11(b).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import encdec, rwkv6, transformer
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.params import count
from repro_torch.models.transformer import Runtime


def _mod(cfg: ModelConfig):
    if cfg.family is Family.SSM:
        return rwkv6
    if cfg.family is Family.ENCDEC:
        return encdec
    return transformer


def decls(cfg: ModelConfig):
    """The family's parameter declarations."""
    return _mod(cfg).param_decls(cfg)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator, rules=None):
        """Random parameters from ``generator``; under mesh ``rules`` with a
        model split, this rank's blocks of the same whole tree (every rank
        draws the whole tree from the same generator state)."""
        params = _mod(self.cfg).init_params(self.cfg, generator)
        if rules is None or rules.tensor_ways <= 1:
            return params
        return rules.shard_tree(params, decls(self.cfg))

    def param_count(self) -> int:
        return count(decls(self.cfg))

    def active_param_count(self) -> int:
        """Parameters a token uses: an ``experts``-axis leaf counts by the
        share experts_per_token / num_experts."""
        if not self.cfg.num_experts:
            return self.param_count()
        return count(decls(self.cfg),
                     active_expert_fraction=self.cfg.experts_per_token / self.cfg.num_experts)

    def flops_per_token(self, train: bool = True) -> float:
        """MODEL_FLOPS basis: 6·N_active (train) / 2·N_active (forward),
        embeddings excluded."""
        emb = self.cfg.vocab_size * self.cfg.d_model
        if not self.cfg.tie_embeddings:
            emb *= 2
        n = self.active_param_count() - emb
        return (6.0 if train else 2.0) * n

    def _split_train_batch(self, batch):
        toks = batch["tokens"]
        kw = dict(tokens=toks[:, :-1], targets=toks[:, 1:],  # VLM: text positions only
                  loss_mask=batch.get("loss_mask"))
        if self.cfg.family is Family.ENCDEC:
            kw["frames"] = batch["frames"]
        elif self.cfg.family is Family.VLM:
            kw["embeds"] = batch["patch_embeds"]
        return kw

    def loss(self, params, batch, runtime: Runtime = Runtime()):
        """Mean next-token cross-entropy; with ``runtime.tensor`` on this
        rank's blocks (the same value on every rank of its model group)."""
        kw = self._split_train_batch(batch)
        return _mod(self.cfg).lm_loss(params, self.cfg, runtime=runtime, **kw)

    def init_cache(self, batch_size: int, max_len: int, src_len: int = 0, device=None,
                   runtime: Runtime = Runtime()):
        """A zeroed cache of ``batch_size`` rows; under ``runtime`` the
        rank's block of it (its kv heads, its span of ``max_len``)."""
        transformer.check_split(self.cfg, runtime)
        if self.cfg.family is Family.ENCDEC:
            return encdec.init_cache(self.cfg, batch_size, max_len, src_len, device=device)
        if self.cfg.family is Family.SSM:
            return rwkv6.init_cache(self.cfg, batch_size, max_len, device=device)
        return transformer.init_cache(self.cfg, batch_size, max_len, device=device,
                                      runtime=runtime)

    def prefill(self, params, batch, cache_len: int, runtime: Runtime = Runtime()):
        transformer.check_split(self.cfg, runtime)
        kw = {}
        if self.cfg.family is Family.ENCDEC:
            kw["frames"] = batch["frames"]
        elif self.cfg.family is Family.VLM:
            kw["embeds"] = batch["patch_embeds"]
        return _mod(self.cfg).prefill(params, self.cfg, tokens=batch["tokens"],
                                      cache_len=cache_len, runtime=runtime, **kw)

    def decode_step(self, params, cache, tokens, runtime: Runtime = Runtime()):
        transformer.check_split(self.cfg, runtime)
        return _mod(self.cfg).decode_step(params, self.cfg, cache, tokens, runtime)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
