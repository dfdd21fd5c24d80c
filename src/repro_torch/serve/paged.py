"""Device-side paged slot state and the serving programs (port of
``repro/serve/paged.py``: ``PagePlan``, ``init_pool``, ``make_admit_fn``,
``make_decode_fn``, ``_paged_transformer_step``).

  * ``make_admit_fn``  — prefill one request (batch 1), scatter its prompt
    KV into the physical page pool at host-chosen page ids, seed the
    slot's next token and the request's output row;
  * ``make_decode_fn`` — ONE batched decode step over all S slots:
    per-slot positions and RoPE, KV writes routed through the page table
    (inactive slots write to the trash page 0), ragged attention over the
    pool, greedy argmax, and the token scatter into the device-resident
    output buffer (inactive slots land in the trash row).

Attention modes:

  * ``dense`` — gather each slot's pages into a contiguous cache and run
    ``models.layers.attention_decode``; the gathered width equals the
    sequential oracle's ``cache_len``, so this path reproduces the
    per-request decode token for token;
  * ``paged`` — K7, the hand-written paged decode kernel (its plain
    version on the CPU): no gathered cache is made.

Families: DENSE, MOE, VLM and HYBRID route through the paged KV pool
(MOE's FFN is ``models/moe.py``'s, reached through
``transformer._ffn_block``; VLM prepends each request's patch embeddings
at admission, so its prompt fills ``prompt_len + n_patches`` positions;
HYBRID adds slot-indexed SSM and conv states, written by the admission's
prefill and advanced by every decode step). SSM (rwkv6) keeps an O(1)
recurrent state per slot, so its "pool" is the slot-indexed state
(``wkv`` / ``tm_x`` / ``cm_x``), its admission prefills through K6 and
writes the final state into the slot, its decode step runs
``rwkv6.decode_step`` over every slot, and the attention modes and page
ids are not read. ENCDEC raises (:func:`check_family`), as in the JAX
package.

The pool, the next tokens and the output buffer belong to the engine that
made them, so both programs write them IN PLACE (``index_put_``; the
JAX package's programs donate them instead).

Under a ``Runtime`` with a ``tensor`` view (a DENSE model on one rank's
blocks, ``dist.tensor_parallel``) the pool holds the rank's kv heads
(whole ``head_dim``), admission prefills the rank's query heads through
K5 and writes its kv heads' pages, the decode step runs K7 on them,
reduces the row-parallel outputs and picks the token
vocabulary-parallel; the tokens, the output buffer and every control
tensor are the same on every rank.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention import gather_pages, paged_attention
from repro_torch.models import rwkv6
from repro_torch.models import transformer as tf
from repro_torch.models.api import Model
from repro_torch.models.config import Family, ModelConfig
from repro_torch.models.layers import attention_decode, rms_norm
from repro_torch.models.transformer import Runtime, static_layer_meta

ATTN_MODES = ("dense", "paged")
_SSM_STATE = ("wkv", "tm_x", "cm_x")
_HYBRID_STATE = ("ssm_state", "conv_state")


def check_family(cfg: ModelConfig) -> None:
    """Continuous batching serves every family but ENCDEC."""
    if cfg.family is Family.ENCDEC:
        raise NotImplementedError(
            "continuous batching does not cover ENCDEC: the cross-attention "
            "source cache is per-request ragged in a second axis"
        )


@dataclasses.dataclass(frozen=True)
class PagePlan:
    """Static paging geometry shared by engine, oracle and tests."""

    page_size: int
    prompt_len: int  # text tokens per request (static prefill shape)
    n_patches: int  # VLM frontend embeddings prepended at prefill
    max_gen: int  # per-request generation cap (sizes the slot span)

    @property
    def prompt_eff(self) -> int:
        """Cached positions after prefill."""
        return self.prompt_len + self.n_patches

    @property
    def span(self) -> int:
        return self.prompt_eff + self.max_gen

    @property
    def pages_per_slot(self) -> int:
        """Page-table width; also fixes the oracle's cache_len."""
        return -(-self.span // self.page_size)

    @property
    def prompt_pages(self) -> int:
        return -(-self.prompt_eff // self.page_size)

    @property
    def cache_len(self) -> int:
        return self.pages_per_slot * self.page_size

    def pages_for_gen(self, gen_len: int) -> int:
        """Physical pages a request with ``gen_len`` decode tokens needs."""
        return -(-(self.prompt_eff + int(gen_len)) // self.page_size)

    @classmethod
    def build(cls, cfg: ModelConfig, prompt_len: int, max_gen: int,
              page_size: int = 16, n_patches: int = 8) -> "PagePlan":
        check_family(cfg)
        return cls(page_size=page_size, prompt_len=prompt_len,
                   n_patches=n_patches if cfg.family is Family.VLM else 0,
                   max_gen=max_gen)


def init_pool(cfg: ModelConfig, plan: PagePlan, slots: int, num_pages: int,
              dtype=None, device=None, runtime: Runtime = Runtime()):
    """Zeroed device state on the CUDA card unless ``device`` names
    another. DENSE: k/v pools (L, num_pages + 1, page, Hkv, hd), physical
    page 0 the trash page (Hkv: the rank's kv heads under
    ``runtime.tensor``); HYBRID adds the slot-indexed float32
    ``ssm_state`` and ``conv_state`` (``transformer.ssm_states``). SSM: the
    slot-indexed recurrent state of ``rwkv6.init_cache`` without ``pos``
    (per-slot positions are host state in serving)."""
    check_family(cfg)
    tp, _ = tf.check_split(cfg, runtime)
    device = resolve_device(device)
    if cfg.family is Family.SSM:
        pool = rwkv6.init_cache(cfg, slots, 0, device=device)
        pool.pop("pos")
        return pool
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    hkv = cfg.num_kv_heads if tp is None else tp.kv_heads
    shape = (cfg.num_layers, num_pages + 1, plan.page_size, hkv, cfg.head_dim)
    pool = {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.family is Family.HYBRID:
        pool.update(tf.ssm_states(cfg, slots, device))
    return pool


def make_admit_fn(model: Model, plan: PagePlan, runtime: Runtime = Runtime()):
    """Returns ``admit(params, pool, tokens, out_buf, prompt, [embeds,]
    pages, slot, req) -> (pool, tokens, out_buf)``, writing its three
    state arguments in place. ``prompt`` is (1, prompt_len) on the device,
    ``pages`` the (prompt_pages,) physical page ids on the device (not
    read for SSM), ``slot``/``req`` ints; VLM models take the extra
    ``embeds`` (1, n_patches, d) on the device. SSM and HYBRID write the
    prefill's final states into the slot's rows."""
    cfg = model.cfg
    check_family(cfg)
    tp, _ = tf.check_split(cfg, runtime)
    ssm = cfg.family is Family.SSM
    is_vlm = cfg.family is Family.VLM
    # Prefill fills whole pages; the padding past the prompt is zeros,
    # overwritten once decode reaches it.
    prefill_len = plan.prompt_pages * plan.page_size
    hkv = cfg.num_kv_heads if tp is None else tp.kv_heads
    shape = None if ssm else (cfg.num_layers, plan.prompt_pages, plan.page_size, hkv,
                              cfg.head_dim)

    @torch.no_grad()
    def admit(params, pool, tokens, out_buf, prompt, *rest):
        if is_vlm:
            embeds, pages, slot, req = rest
            batch = {"tokens": prompt, "patch_embeds": embeds}
        else:
            pages, slot, req = rest
            batch = {"tokens": prompt}
        logits, cache = model.prefill(params, batch, cache_len=prefill_len, runtime=runtime)
        first = tf.greedy(logits[0, -1], runtime)
        if ssm:
            for key in _SSM_STATE:
                pool[key][:, slot] = cache[key][:, 0]
        else:
            pool["k"][:, pages] = cache["k"][:, 0].reshape(shape)
            pool["v"][:, pages] = cache["v"][:, 0].reshape(shape)
            if cfg.family is Family.HYBRID:
                for key in _HYBRID_STATE:
                    pool[key][:, slot] = cache[key][:, 0]
        tokens[slot, 0] = first
        out_buf[req, 0] = first.to(out_buf.dtype)
        return pool, tokens, out_buf

    return admit


@torch.no_grad()
def _paged_transformer_step(params, cfg: ModelConfig, plan: PagePlan, pool, tokens,
                            page_table, positions, active, runtime: Runtime,
                            attn: str, dense_attention=None):
    """Slot-batched analogue of ``transformer.decode_step``: per-slot
    ``positions`` (S,) and the page pool instead of a contiguous cache.
    Writes the new KV (and HYBRID's SSM and conv states, every slot's)
    into ``pool`` in place; returns (logits (S,1,V), pool).
    ``dense_attention`` is the dense mode's attention over the gathered
    cache (``attention_decode``'s arguments; by default that function). Under ``runtime.tensor`` the
    step runs on the rank's heads and the logits are its vocabulary
    block."""
    s = tokens.shape[0]
    page = plan.page_size
    x = tf.embed_tokens(params, cfg, tokens, runtime)  # (S, 1, d)
    pos2 = positions[:, None]  # (S, 1) per-slot RoPE positions
    rows = torch.arange(s, device=tokens.device)
    # New-token KV target: the slot's current page, or the trash page 0.
    tgt = torch.where(active, page_table[rows, positions // page].long(), 0)
    off = positions % page
    lengths = torch.where(active, positions + 1, 0).to(torch.int32)
    k_pool, v_pool = pool["k"], pool["v"]
    for i in range(cfg.num_layers):
        lp = tf.layer_params(params, i)
        w_i, th_i = static_layer_meta(cfg, i)
        h = rms_norm(x, lp["attn_norm"], cfg.rms_eps)
        q, k, v = tf.layer_qkv(lp, cfg, h, pos2, th_i, runtime)
        k_pool[i, tgt, off] = k[:, 0]
        v_pool[i, tgt, off] = v[:, 0]
        if attn == "paged":
            out = paged_attention(q[:, 0], k_pool[i], v_pool[i], page_table, lengths,
                                  w_i)[:, None]
        else:
            kg = gather_pages(k_pool[i], page_table)  # (S, cache_len, Hkv, hd)
            vg = gather_pages(v_pool[i], page_table)
            out = (dense_attention or attention_decode)(q, kg, vg, positions, w_i)
        a = tf.layer_attn_out(lp, out, runtime)
        if cfg.family is Family.HYBRID:
            a = 0.5 * (a + tf.hybrid_decode(lp, cfg, x, pool, i))
        x = x + a
        h = rms_norm(x, lp["mlp_norm"], cfg.rms_eps)
        x = x + tf.layer_ffn(lp, cfg, h, runtime)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return tf.head_logits(params, cfg, x, runtime), pool


def make_decode_fn(model: Model, plan: PagePlan, runtime: Runtime = Runtime(),
                   attn: str = "dense"):
    """Returns ``step(params, pool, tokens, out_buf, page_table, positions,
    active, out_req, out_idx) -> (pool, tokens, out_buf)``: the one program
    that serves the whole trace. ``pool`` and ``out_buf`` are written in
    place, ``tokens`` comes back new; ``step(..., keep_logits=True)`` also
    returns the step's last-position logits (S, V), the rank's vocabulary
    block under ``runtime.tensor``. ``out_req``/``out_idx`` route each
    slot's token into the output buffer; the host passes the trash row for
    inactive slots. SSM advances every slot's state (an inactive slot's is
    overwritten at its next admission) and reads neither the page table
    nor the positions."""
    cfg = model.cfg
    check_family(cfg)
    tf.check_split(cfg, runtime)
    if attn not in ATTN_MODES:
        raise ValueError(f"attn must be one of {ATTN_MODES}, got {attn!r}")

    @torch.no_grad()
    def step(params, pool, tokens, out_buf, page_table, positions, active, out_req,
             out_idx, keep_logits: bool = False):
        if cfg.family is Family.SSM:
            logits, cache = rwkv6.decode_step(params, cfg, dict(pool, pos=0), tokens)
            pool = {key: cache[key] for key in _SSM_STATE}
        else:
            logits, pool = _paged_transformer_step(params, cfg, plan, pool, tokens,
                                                   page_table, positions, active,
                                                   runtime, attn)
        nxt = tf.greedy(logits[:, -1], runtime)  # (S,)
        out_buf[out_req, out_idx] = nxt.to(out_buf.dtype)
        if keep_logits:
            return pool, nxt[:, None], out_buf, logits[:, -1]
        return pool, nxt[:, None], out_buf

    return step
