"""Uniform model interface (port of ``repro/models/api.py``), for the
DENSE, MOE and SSM (rwkv6) families.

``build_model(cfg)`` returns a ``Model`` whose methods close over the
config and dispatch on its family, as the JAX package's do:

    model.init(generator)                      -> params (on its device)
    model.loss(params, batch)                  -> scalar CE loss
    model.prefill(params, batch, cache_len)    -> (logits, cache)
    model.decode_step(params, cache, tokens)   -> (logits, cache)
    model.init_cache(batch, max_len, device)   -> cache
    model.param_count() / active_param_count() / flops_per_token()

Other families raise ``NotImplementedError`` naming the ROADMAP item that
ports them (item 10(b2)).

``batch`` holds ``tokens`` (B, S+1): inputs and next-token targets are
derived here, and an optional ``loss_mask`` (B, S).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import rwkv6, transformer
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.params import count
from repro_torch.models.transformer import Runtime


def check_family(cfg: ModelConfig) -> None:
    """The families the port builds: DENSE, MOE and SSM."""
    if cfg.family is not Family.SSM:
        transformer.check_trunk(cfg)


def _mod(cfg: ModelConfig):
    check_family(cfg)
    return rwkv6 if cfg.family is Family.SSM else transformer


def decls(cfg: ModelConfig):
    """The family's parameter declarations."""
    return _mod(cfg).param_decls(cfg)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator):
        return _mod(self.cfg).init_params(self.cfg, generator)

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
        return dict(tokens=toks[:, :-1], targets=toks[:, 1:],
                    loss_mask=batch.get("loss_mask"))

    def loss(self, params, batch, runtime: Runtime = Runtime()):
        kw = self._split_train_batch(batch)
        return _mod(self.cfg).lm_loss(params, self.cfg, runtime=runtime, **kw)

    def init_cache(self, batch_size: int, max_len: int, device=None):
        return _mod(self.cfg).init_cache(self.cfg, batch_size, max_len, device=device)

    def prefill(self, params, batch, cache_len: int, runtime: Runtime = Runtime()):
        return _mod(self.cfg).prefill(params, self.cfg, tokens=batch["tokens"],
                                      cache_len=cache_len, runtime=runtime)

    def decode_step(self, params, cache, tokens, runtime: Runtime = Runtime()):
        return _mod(self.cfg).decode_step(params, self.cfg, cache, tokens, runtime)


def build_model(cfg: ModelConfig) -> Model:
    check_family(cfg)
    return Model(cfg)
