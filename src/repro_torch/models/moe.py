"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``), on one device.

  * ``moe_ffn_reference`` — every expert processes every token, outputs
    combined by router weights: the semantic oracle of the others;
  * ``moe_ffn_dropless``  — the served route: the assignments sorted by
    expert and grouped products over the experts' runs; every (token,
    expert) assignment is kept, with no host synchronisation and fixed
    shapes;
  * ``moe_ffn_gshard``    — capacity dispatch as einsums over one-hot
    dispatch / combine tensors: tokens past an expert's per-group capacity
    are dropped, as in the JAX function;
  * ``moe_ffn_ep``        — the expert-parallel mesh path: raises
    (ROADMAP.md queue 1, item 11(b)).

Router convention (mixtral / moonlight): softmax over the expert logits
in float32, top-k, the top-k probabilities renormalised to sum to 1. The
expert products are library calls, ``torch._grouped_mm`` in the served
route and ``torch.bmm`` / ``torch.einsum`` in the others (the JAX package
computes them with ``jax.lax.ragged_dot`` and einsums, outside any Pallas
kernel).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

Array = torch.Tensor


def router_topk(xf: Array, w_router: Array, k: int):
    """xf: (t, d) -> (topk_probs (t, k) float32 renormalised, topk_idx (t, k)
    int64). Ties go to the lower expert index, as ``jax.lax.top_k`` breaks
    them: a stable descending sort, whose first k columns are the top k."""
    logits = xf.float() @ w_router.float()  # (t, E)
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_p, topk_i = topk_p[:, :k], topk_i[:, :k]
    return topk_p / torch.sum(topk_p, dim=-1, keepdim=True), topk_i


def _act(act: str):
    if act == "silu":
        return torch.nn.functional.silu
    return lambda z: torch.nn.functional.gelu(z, approximate="tanh")


def _expert_ffn(h_in: Array, wg: Array, wu: Array, wd: Array, act: str) -> Array:
    """Per-expert gated FFN. h_in: (E, C, d); w*: (E, d, ff) / (E, ff, d)."""
    gate = torch.bmm(h_in, wg)
    up = torch.bmm(h_in, wu)
    return torch.bmm(_act(act)(gate) * up, wd)


# --------------------------------------------------------------------- #
# Reference (dense) implementation — the oracle.
# --------------------------------------------------------------------- #
def moe_ffn_reference(x: Array, w_router: Array, wg: Array, wu: Array, wd: Array,
                      cfg: ModelConfig) -> Array:
    """x: (B, S, d). Computes all experts on all tokens, combines by router."""
    b, s, d = x.shape
    e = cfg.num_experts
    xf = x.reshape(b * s, d)
    topk_p, topk_i = router_topk(xf, w_router, cfg.experts_per_token)
    combine = torch.zeros((b * s, e), dtype=torch.float32, device=x.device)
    combine.scatter_(1, topk_i, topk_p)  # (t, E) combine weights
    all_out = _expert_ffn(xf.expand(e, b * s, d), wg, wu, wd, cfg.act)  # (E, t, d)
    y = torch.einsum("te,etd->td", combine, all_out.float())
    return y.reshape(b, s, d).to(x.dtype)


# --------------------------------------------------------------------- #
# Dropless dispatch: the served route.
# --------------------------------------------------------------------- #
def moe_ffn_dropless(x: Array, w_router: Array, wg: Array, wu: Array, wd: Array,
                     cfg: ModelConfig) -> Array:
    """Sort the (t·k) assignments by expert, run grouped products over the
    experts' runs, combine back, as the JAX function does with
    ``jax.lax.ragged_dot``. ``torch._grouped_mm`` takes the runs' end
    offsets as a device tensor, so every shape is fixed and the products
    cover the t·k assignment rows and the weights of the experts hit,
    nothing more. The offsets come from ``searchsorted`` over the sorted
    experts (CUDA's ``bincount`` reads its size on the host); the outputs
    return to (token, slot) order by the inverse permutation and are
    summed with the router weights in float32. No ``.item()``, ``nonzero``
    or boolean indexing: the decode step stays free of host
    synchronisations. Every assignment is kept.
    """
    b, s, d = x.shape
    k = cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    topk_p, topk_i = router_topk(xf, w_router, k)
    flat_e = topk_i.reshape(-1)  # (t·k,)
    order = torch.argsort(flat_e, stable=True)
    offs = torch.searchsorted(flat_e[order],
                              torch.arange(cfg.num_experts, device=x.device),
                              right=True).to(torch.int32)  # (E,) end of each run
    xs = xf[order // k]  # (t·k, d) tokens in expert order
    gate = torch._grouped_mm(xs, wg, offs=offs)
    up = torch._grouped_mm(xs, wu, offs=offs)
    out = torch._grouped_mm(_act(cfg.act)(gate) * up, wd, offs=offs)  # (t·k, d)
    y = out[torch.argsort(order)].float().view(t, k, d) * topk_p[..., None]
    return y.sum(dim=1).reshape(b, s, d).to(x.dtype)


# --------------------------------------------------------------------- #
# GShard-style grouped einsum implementation.
# --------------------------------------------------------------------- #
def _one_hot(idx: Array, n: int, dtype) -> Array:
    """``jax.nn.one_hot``: indices outside [0, n) give an all-zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_ffn_gshard(x: Array, w_router: Array, wg: Array, wu: Array, wd: Array,
                   cfg: ModelConfig, *, group_size: int = 512, mesh=None,
                   expert_axis: str | None = None,
                   group_axes: tuple[str, ...] | None = None,
                   tp_axis: str | None = None) -> Array:
    """Capacity-dispatch MoE as einsums (the GShard formulation). Tokens
    are viewed as (G, S_g) groups with a per-group capacity C per expert;
    an assignment whose position in its expert's group buffer is C or
    more is dropped (its token gets nothing from that expert). The
    dispatch / combine one-hots are built in the compute dtype. The mesh
    arguments belong to the distributed path (ROADMAP.md queue 1, item
    11): only ``mesh=None`` is ported."""
    del expert_axis, group_axes, tp_axis
    if mesh is not None:
        raise NotImplementedError(
            "moe_ffn_gshard on a mesh is not ported yet: ROADMAP.md queue 1, item 11(b) "
            "(dist/ -> torch.distributed) ports it"
        )
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    g_sz = min(group_size, t)
    assert t % g_sz == 0, (t, g_sz)
    g = t // g_sz
    cap = _capacity(g_sz, k, e, cfg.moe_capacity_factor)

    xg = x.reshape(g, g_sz, d)
    topk_p, topk_i = router_topk(x.reshape(t, d), w_router, k)
    topk_p = topk_p.reshape(g, g_sz, k)
    topk_i = topk_i.reshape(g, g_sz, k)

    oh = _one_hot(topk_i, e, torch.float32)  # (G, S, k, E)
    route = torch.sum(oh, dim=2)  # (G, S, E) in {0, 1}
    probs = torch.einsum("gske,gsk->gse", oh, topk_p)
    # Position of each (token, expert) assignment within the expert's
    # per-group capacity buffer: cumsum over the token dim.
    pos = torch.cumsum(route, dim=1) - 1.0
    keep = (pos < cap) & (route > 0)
    cd = getattr(torch, cfg.compute_dtype)
    pos_oh = _one_hot(pos.to(torch.int32), cap, cd)  # (G, S, E, C)
    dispatch = pos_oh * keep[..., None].to(cd)
    combine = dispatch * probs[..., None].to(cd)

    wdt = torch.promote_types(cd, x.dtype)
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch.to(wdt), xg.to(wdt))
    gate = torch.einsum("egcd,edf->egcf", expert_in, wg.to(wdt))
    up = torch.einsum("egcd,edf->egcf", expert_in, wu.to(wdt))
    h = _act(cfg.act)(gate) * up
    out = torch.einsum("egcf,efd->egcd", h, wd.to(wdt))
    y = torch.einsum("gsec,egcd->gsd", combine.to(wdt), out)
    return y.reshape(b, s, d).to(x.dtype)


# --------------------------------------------------------------------- #
# Capacity dispatch helpers (the expert-parallel path's local half).
# --------------------------------------------------------------------- #
def _capacity(tokens: int, k: int, num_experts: int, factor: float) -> int:
    c = int(tokens * k / num_experts * factor)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def _local_dispatch(xf: Array, topk_p: Array, topk_i: Array, num_experts: int,
                    capacity: int):
    """Build the (E, C, d) capacity buffer and the combine metadata, locally.

    Returns (buffer, slot_expert, slot_pos, slot_weight, slot_token, keep),
    each slot in expert order (a stable sort of the (t·k) assignments)."""
    t, k = topk_i.shape
    flat_e = topk_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(num_experts, dtype=torch.int64, device=xf.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=0) - counts  # start of each expert's run
    pos_in_e = torch.arange(t * k, device=xf.device) - offsets[sorted_e]
    keep = pos_in_e < capacity
    tok_of_slot = order // k
    # Dropped slots go to one extra row past the buffer, cut off after the
    # scatter (never colliding with a kept slot).
    safe_pos = torch.where(keep, pos_in_e, capacity)
    buf = xf.new_zeros((num_experts, capacity + 1, xf.shape[-1]))
    buf[sorted_e, safe_pos] = xf[tok_of_slot]
    buf = buf[:, :capacity]
    # Clamped for the gather on the combine side (weights zero the dropped).
    safe_pos = torch.clamp(safe_pos, max=capacity - 1)
    weight = topk_p.reshape(-1)[order] * keep  # (t·k,) float32
    return buf, sorted_e, safe_pos, weight, tok_of_slot, keep


def moe_ffn_ep(x: Array, w_router: Array, wg: Array, wu: Array, wd: Array,
               cfg: ModelConfig, mesh, *, batch_axes: tuple[str, ...] = (),
               expert_axis: str | None = None, tp_axis: str | None = None) -> Array:
    """Expert-parallel MoE over a device mesh: not ported yet."""
    raise NotImplementedError(
        "moe_ffn_ep (expert parallelism over a mesh) is not ported yet: ROADMAP.md "
        "queue 1, item 11(b) ports it"
    )
