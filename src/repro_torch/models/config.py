"""Model configuration (port of ``repro/models/config.py``).

One dataclass describes every LM-family member of the JAX package:
dense GQA transformers, MoE, mixed local/global attention, hybrid
attention + SSM (hymba), attention-free RWKV6, encoder-decoder (the
seamless backbone) and the embedding-frontend VLM stub. The port builds
every family.
"""
from __future__ import annotations

import dataclasses
import enum


class Family(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    ENCDEC = "encdec"
    HYBRID = "hybrid"
    SSM = "ssm"
    VLM = "vlm"


# Marker for "global attention" entries in layer window patterns.
GLOBAL = -1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family

    # Transformer trunk.
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Attention details.
    qkv_bias: bool = False
    qk_norm: bool = False
    scale_embeddings: bool = False
    # Per-layer attention window pattern, cycled over layers. GLOBAL means
    # full causal attention; a positive int is a sliding window.
    window_pattern: tuple[int, ...] = (GLOBAL,)
    rope_theta_global: float = 1_000_000.0
    rope_theta_local: float = 10_000.0
    logit_softcap: float = 0.0

    # MoE.
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM / hybrid.
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_dt_rank: int = 0

    # Encoder-decoder.
    num_encoder_layers: int = 0

    # Frontend stubs (VLM / audio).
    embed_frontend_fraction: float = 0.0

    # Norm/act details.
    rms_eps: float = 1e-6
    act: str = "silu"  # "silu" (SwiGLU) or "gelu" (GeGLU)
    tie_embeddings: bool = False

    # Dtypes.
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # Runtime knobs (not architecture). The port runs its layers as a
    # Python loop, so ``scan_layers``, ``scan_block`` and the remat knobs
    # are kept for the configuration's sake and read by nothing here.
    attn_impl: str = "auto"  # "auto" | "xla" | "xla_chunked" | "flash"
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    remat: bool = True
    remat_policy: str = "nothing"
    loss_chunk: int = 1024
    scan_layers: bool = True
    scan_block: int = 0
    split_local_global_cache: bool = False

    def __post_init__(self):
        if self.family is not Family.SSM:
            assert self.num_heads > 0 and self.head_dim > 0
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
                f"{self.name}: q heads {self.num_heads} must be a multiple of "
                f"kv heads {self.num_kv_heads}"
            )
        if self.family is Family.MOE:
            assert self.num_experts > 0 and self.experts_per_token > 0
        if self.family is Family.ENCDEC:
            assert self.num_encoder_layers > 0

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 128; logits over the pad
        are masked to -inf."""
        return -(-self.vocab_size // 128) * 128

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(self.d_model // 16, 1)

    @property
    def d_inner(self) -> int:
        """SSM inner width (hybrid family)."""
        return self.d_model

    def layer_windows(self) -> tuple[int, ...]:
        """Resolved per-layer window sizes, GLOBAL -> -1 sentinel kept."""
        pat = self.window_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU tests."""
        small = dict(
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_heads else 0,
            head_dim=16 if self.num_heads else 0,
            d_ff=128,
            vocab_size=256,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token
            else 0,
            num_encoder_layers=min(self.num_encoder_layers, 2)
            if self.num_encoder_layers
            else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_dt_rank=8 if self.ssm_state else 0,
            window_pattern=tuple(
                (w if w == GLOBAL else min(w, 32)) for w in self.window_pattern
            ),
            loss_chunk=0,
            remat=False,
            name=self.name + "-reduced",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def param_count(self) -> int:
        """Closed-form parameter count, as the JAX package's roofline takes
        it: over the true vocab, and without hymba's ``ssm_norm``, so below
        ``Model.param_count()`` (the declarations' count) for configs whose
        vocab is padded or that have an SSM branch."""
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family is Family.SSM:  # RWKV6
        # time-mix: r/k/v/g/o (5 d*d) + decay lora (d*64*2) + maa lora
        # (d*32*5 + 5*32*d) + u (d) + ln params; channel-mix: k (d*ff),
        # v (ff*d), r (d*d).
        tm = 5 * d * d + 2 * 64 * d + 5 * 32 * d * 2 + d + 2 * d + 2 * d
        cm = d * ff + ff * d + d * d
        return cfg.num_layers * (tm + cm + 2 * d) + emb + d

    attn = d * cfg.attn_dim + 2 * d * cfg.kv_dim + cfg.attn_dim * d
    if cfg.qkv_bias:
        attn += cfg.attn_dim + 2 * cfg.kv_dim
    if cfg.num_experts:
        ffn_total = cfg.num_experts * 3 * d * ff + d * cfg.num_experts
        ffn_active = cfg.experts_per_token * 3 * d * ff + d * cfg.num_experts
    else:
        ffn_total = ffn_active = 3 * d * ff
    per_layer = attn + (ffn_active if active_only else ffn_total) + 2 * d  # + norms
    if cfg.family is Family.HYBRID:
        # SSM branch: in_proj (d -> 2*d_inner), conv, dt/B/C proj, A, D, out.
        di, st, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
        per_layer += (d * 2 * di + di * cfg.ssm_conv + di * (dtr + 2 * st) + dtr * di
                      + di * st + 2 * di + di * d)
    extra = 0
    if cfg.family is Family.ENCDEC:  # decoder layers add cross-attention
        extra = cfg.num_layers * (d * cfg.attn_dim + 2 * d * cfg.kv_dim + cfg.attn_dim * d + d)
    return (cfg.num_layers + cfg.num_encoder_layers) * per_layer + extra + emb + d
