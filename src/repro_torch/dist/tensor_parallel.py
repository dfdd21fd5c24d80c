"""Tensor parallelism over a plan's model axes, ``tp`` and ``sp``, for the
DENSE family's LM round and its serving, and the sequence split of
static serving over the data axes (no JAX counterpart: GSPMD inserts
these collectives from the sharding constraints).

Each rank holds its block of every parameter (``ShardingRules.
tensor_specs``: ``heads`` / ``kv`` on tp, ``head_dim`` on sp, ``mlp`` /
``vocab`` on tp × sp, each only where the axis divides the dim) and
computes the layer on it. Four ``torch.autograd.Function`` s over one
mesh-axis group carry the values between the blocks:

  * ``copy``: identity forward, all-reduce backward: a replicated value
    (or a replicated leaf) that a split computation reads, whose
    gradient comes back as one share per rank;
  * ``reduce``: all-reduce forward, identity backward: a row-parallel
    product's partial sums, read by replicated computation after it;
  * ``gather``: all-gather forward (along the last dim), reduce-scatter
    backward (an all-reduce, then the rank's slice): q, k and v split
    over sp made whole over ``head_dim`` for RoPE, ``qk_norm`` and
    attention, which every rank of the sp group then computes alike;
    each rank reads only its ``head_dim`` columns of the output (its
    ``wo`` block), so each holds a share of the whole gradient;
  * ``vocab_ce``: the vocabulary-parallel cross-entropy: the max, the
    sum of exponentials and the gold logit reduced over the vocabulary
    blocks; its backward is local (softmax minus one-hot).

Every call goes through ``torch.distributed.<op>``, so
``dist.collectives.CollectiveLog`` records it. :class:`TensorParallel` is
one rank's view: the axes each part of the layer splits over, the heads,
``head_dim`` columns and vocabulary rows it holds, and the server pass's
gathers of the (C_local, P_local) delta rows, the parameters and the
momentum into whole rows (JAX ``shard_p=False``: P whole within a client
shard) and the blocks kept after it.

The training loss and serving (``models/transformer``, ``serve/paged``)
run the same layer: q, k and v of the rank's heads are gathered whole
over ``head_dim`` in one all-gather (one tensor packed along the heads)
before RoPE, so attention (K5 and K7 in serving) runs with whole rows,
replicated over sp; ``wo`` stays row-parallel over tp × sp and its
partial sums are reduced, as the MLP's are. Serving also holds the
``qk_norm`` scales whole, gathered once (:meth:`TensorParallel.
serving_params`); the rank's cache or page pool holds the kv heads its
query heads read (:attr:`TensorParallel.kv_heads`); and the greedy pick
is vocabulary-parallel (:meth:`TensorParallel.argmax`: each block's max
and index, then one all-gather), so no rank holds the whole (B, V)
logits.

:class:`SequenceParallel` is a rank's view of the static engine's
sequence split (``ShardingRules.serve_layout`` kind "sequence"): each
rank prefills its span of the prompt against the keys and values
gathered over the data axes, keeps its span of the cache, and a decode
step merges the ranks' partial softmaxes by two all-reduces (the max,
then the rescaled sums and outputs): flash-decode across shards, as the
JAX package's ``_replicate_small`` makes GSPMD do.

Only DENSE is executed: the expert axis, HYBRID's ``ssm`` dims and the
VLM, ENCDEC, SSM and MoE families raise, naming ROADMAP item 11(b).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree

_QUEUED = "ROADMAP.md queue 1, item 11(b)"
# the layer's attention leaves: they run split over the attention axes
ATTN_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm", "k_norm")


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    dist = torch.distributed
    if hasattr(dist, "all_gather_single"):
        dist.all_gather_single(out, x, group=group)
    else:
        dist.all_gather_into_tensor(out, x, group=group)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ways: int, index: int):
        n = x.shape[-1]
        ctx.lo, ctx.hi, ctx.group = index * n, (index + 1) * n, group
        flat = x.contiguous().reshape(-1)
        out = torch.empty((ways * flat.numel(),), dtype=x.dtype, device=x.device)
        _all_gather(out, flat, group)
        out = out.view((ways,) + tuple(x.shape)).movedim(0, -2)
        return out.reshape(tuple(x.shape[:-1]) + (ways * n,))

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g[..., ctx.lo:ctx.hi].contiguous(), None, None, None


class _VocabCE(torch.autograd.Function):
    """Per-position cross-entropy of float32 logits split over the
    vocabulary: ``logits`` (..., V_local) holds columns [v_lo, v_lo +
    V_local) of the whole row; ``targets`` (...) are whole-vocabulary ids.
    Returns (...) logsumexp − gold logit, the same on every rank."""

    @staticmethod
    def forward(ctx, logits, targets, v_lo: int, group):
        dist = torch.distributed
        n = logits.shape[-1]
        m = torch.amax(logits, dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        z = logits - m[..., None]
        e = torch.exp(z)
        t = targets.to(torch.int64) - v_lo
        here = (t >= 0) & (t < n)
        t = torch.clamp(t, 0, n - 1)
        gold = torch.gather(z, -1, t[..., None])[..., 0] * here
        packed = torch.stack([torch.sum(e, dim=-1), gold])
        dist.all_reduce(packed, group=group)
        ctx.save_for_backward(e, packed[0], t, here)
        return torch.log(packed[0]) - packed[1]

    @staticmethod
    def backward(ctx, g):
        e, s, t, here = ctx.saved_tensors
        grad = e / s[..., None]
        grad.scatter_add_(-1, t[..., None], -here.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


def _span(n: int, ways: int, index: int) -> tuple[int, int]:
    per = n // ways
    return index * per, (index + 1) * per


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's tensor-parallel view of a DENSE model under mesh rules
    (see the module docstring). Build it with :meth:`from_rules`."""

    rules: object  # dist.sharding.ShardingRules
    decls: object  # the model's full ParamDecl tree
    attn_axes: tuple[str, ...]  # axes the attention block splits over
    hd_axes: tuple[str, ...]  # axes head_dim splits over (gathered for RoPE)
    mlp_axes: tuple[str, ...]
    vocab_axes: tuple[str, ...]
    q_heads: tuple[int, int]  # the query heads this rank computes
    kv_used: tuple[int, int]  # the kv heads they read, within the held block
    vocab: tuple[int, int]  # the vocabulary rows this rank holds
    leaf_copies: dict  # layer leaf -> axes its gradient sums over

    @classmethod
    def from_rules(cls, rules):
        """The view for ``rules`` (None when the model axes span one rank).
        Raises for what is not executed: a model axis > 1 on a family
        other than DENSE, or the expert axis."""
        if rules.tensor_ways <= 1:
            return None
        from repro_torch.models.api import decls as family_decls
        from repro_torch.models.config import Family

        cfg = rules.cfg
        if "expert" in rules.tensor_axes:
            raise NotImplementedError(
                f"{cfg.name}: the expert axis (moe_ffn_ep, moe_ffn_gshard(mesh=...)) "
                f"is not executed yet: {_QUEUED}, step 3")
        if cfg.family is not Family.DENSE:
            raise NotImplementedError(
                f"{cfg.name}: the tensor axes of the {cfg.family.value} family (HYBRID's "
                f"ssm dims, VLM, ENCDEC, SSM, MoE) are not executed yet; DENSE only: "
                f"{_QUEUED}")
        decls = family_decls(cfg)
        specs = dict(zip(_paths(decls), rules.tensor_specs(decls)))
        from repro_torch.dist.sharding import entry_axes

        def axes_of(path, dim):
            return entry_axes(specs[path][dim])

        heads, hd = axes_of(("layers", "wq"), 2), axes_of(("layers", "wq"), 3)
        kv = axes_of(("layers", "wk"), 2)
        tp = rules.mesh.shape.get("tp", 1)
        if tp > 1 and heads != ("tp",):
            raise ValueError(f"{cfg.name}: {cfg.num_heads} heads do not divide over tp={tp}")
        mesh = rules.mesh
        h, hkv = cfg.num_heads, cfg.num_kv_heads
        q_lo, q_hi = _span(h, mesh.ways(heads), mesh.index(heads))
        g = h // hkv
        held_lo, _ = _span(hkv, mesh.ways(kv), mesh.index(kv))
        u_lo, u_hi = q_lo // g, (q_hi - 1) // g + 1
        per = (q_hi - q_lo) // (u_hi - u_lo)
        if any((q_lo + j) // g - u_lo != j // per for j in range(q_hi - q_lo)):
            raise NotImplementedError(
                f"{cfg.name}: query heads [{q_lo}, {q_hi}) do not map onto whole kv "
                f"groups of {g}")
        attn = heads + hd
        copies = {}
        for name in ATTN_LEAVES:
            if ("layers", name) in specs:
                own = {a for e in specs[("layers", name)] for a in entry_axes(e)}
                copies[name] = tuple(a for a in attn if a not in own)
        vocab_axes = axes_of(("embed",), 0)
        return cls(
            rules=rules, decls=decls, attn_axes=attn, hd_axes=hd,
            mlp_axes=axes_of(("layers", "w_gate"), 2), vocab_axes=vocab_axes,
            q_heads=(q_lo, q_hi), kv_used=(u_lo - held_lo, u_hi - held_lo),
            vocab=_span(cfg.padded_vocab, mesh.ways(vocab_axes), mesh.index(vocab_axes)),
            leaf_copies=copies,
        )

    # ------------------------------------------------------------------ #
    # The layer's collectives
    # ------------------------------------------------------------------ #
    @property
    def mesh(self):
        return self.rules.mesh

    def _group(self, axes):
        return self.mesh.group(tuple(axes))

    def copy(self, x: torch.Tensor, axes) -> torch.Tensor:
        return _Copy.apply(x, self._group(axes)) if axes else x

    def reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        return _Reduce.apply(x, self._group(axes)) if axes else x

    def gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x`` whole along its last dim, split over ``axes``."""
        if not axes:
            return x
        return _Gather.apply(x, self._group(axes), self.mesh.ways(axes), self.mesh.index(axes))

    def vocab_ce(self, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return _VocabCE.apply(logits, targets, self.vocab[0], self._group(self.vocab_axes))

    # ------------------------------------------------------------------ #
    # Serving
    # ------------------------------------------------------------------ #
    @property
    def kv_heads(self) -> int:
        """The kv heads this rank's cache or page pool holds: those its
        query heads read."""
        return self.kv_used[1] - self.kv_used[0]

    def argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The vocabulary-parallel greedy pick: ``logits`` (..., V_local),
        this rank's vocabulary block -> (...) int64 whole-vocabulary ids,
        the same on every rank. Each block's max and its (first) index go
        out in one all-gather; the first block holding the largest max
        wins, so ties resolve to the smallest id, as ``torch.argmax``."""
        if not self.vocab_axes:
            return torch.argmax(logits, dim=-1)
        idx = torch.argmax(logits, dim=-1)
        best = torch.gather(logits, -1, idx[..., None])[..., 0]
        pack = torch.stack([best.double(), (idx + self.vocab[0]).double()], dim=-1)
        ways = self.mesh.ways(self.vocab_axes)
        out = torch.empty((ways,) + tuple(pack.shape), dtype=pack.dtype, device=pack.device)
        _all_gather(out.view(-1), pack.contiguous().view(-1), self._group(self.vocab_axes))
        win = torch.argmax(out[..., 0], dim=0)
        return torch.gather(out[..., 1], 0, win[None])[0].long()

    def gather_heads(self, *xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Tensors (..., heads, hd_local) made whole over ``head_dim`` in one
        all-gather over the sp axes (packed along the heads)."""
        if not self.hd_axes:
            return xs
        whole = self.gather(torch.cat(xs, dim=-2), self.hd_axes)
        return torch.split(whole, [x.shape[-2] for x in xs], dim=-2)

    def whole_head_dim(self, w: torch.Tensor, head_dim: int) -> torch.Tensor:
        """A ``head_dim`` leaf (the ``qk_norm`` scales) whole: gathered over
        the sp axes where it is the rank's block (the training loss), as it
        comes where :meth:`serving_params` made it whole."""
        return w if w.shape[-1] == head_dim else self.gather(w, self.hd_axes)

    def serving_params(self, params):
        """``params`` (the rank's blocks) with the ``qk_norm`` scales made
        whole over ``head_dim``, one all-gather a leaf: serving reads them
        every step and they never change. The same tree where they are
        whole already (no sp split, no ``qk_norm``, or made so before)."""
        layers = params["layers"]
        if not self.hd_axes or "q_norm" not in layers:
            return params
        hd = self.rules.cfg.head_dim
        whole = {k: self.whole_head_dim(layers[k], hd) for k in ("q_norm", "k_norm")}
        return dict(params, layers=dict(layers, **whole))

    def head_dim_block(self, x: torch.Tensor) -> torch.Tensor:
        """A whole-``head_dim`` tensor's columns that this rank's row-parallel
        ``wo`` block reads."""
        if not self.hd_axes:
            return x
        n = x.shape[-1] // self.mesh.ways(self.hd_axes)
        i = self.mesh.index(self.hd_axes)
        return x[..., i * n:(i + 1) * n]

    # ------------------------------------------------------------------ #
    # The server pass: whole rows in, this rank's blocks out
    # ------------------------------------------------------------------ #
    @property
    def local_decls(self):
        return self.rules.local_decls(self.decls)

    def _members(self) -> list[tuple[int, list]]:
        """(member, its block slices per leaf) for every member of this
        rank's model group, in group order."""
        return [(j, self.rules.block_slices(self.decls, self.rules.member_coords(j)))
                for j in range(self.rules.tensor_ways)]

    def _gather_into(self, blocks, dsts, rows: int | None, leaves=None) -> None:
        """All-gather each leaf's block (``blocks[i]``, shaped ``(rows, *local)``
        or ``local``) over the model group and write every member's block
        into ``dsts[i]`` (the whole leaf, with the same leading rows).
        ``leaves[i]``: the leaf index of ``blocks[i]`` (default ``i``)."""
        ways = self.rules.tensor_ways
        group = self._group(self.rules.tensor_axes)
        members = self._members()
        lead = (slice(None),) if rows is not None else ()
        for i, blk, dst in zip(leaves or range(len(blocks)), blocks, dsts):
            flat = blk.contiguous().reshape(-1)
            out = torch.empty((ways * flat.numel(),), dtype=blk.dtype, device=blk.device)
            _all_gather(out, flat, group)
            parts = out.view((ways,) + tuple(blk.shape))
            seen = set()
            for j, slices in members:
                key = tuple((s.start, s.stop) for s in slices[i])
                if key not in seen:
                    seen.add(key)
                    dst[lead + slices[i]] = parts[j]
            del out, parts

    def _spans(self, decls):
        sizes = [math.prod(d.shape) for d in tree.leaves(decls)]
        offs = [sum(sizes[:i]) for i in range(len(sizes))]
        return list(zip(offs, sizes, [d.shape for d in tree.leaves(decls)]))

    def gather_rows(self, buf: torch.Tensor) -> torch.Tensor:
        """This rank's (C_local, P_local) delta rows -> whole (C_local, P)
        float32 rows in the single-process layout (leaf order, each leaf
        row-major)."""
        c = buf.shape[0]
        full = self._spans(self.decls)
        p = sum(n for _, n, _ in full)
        out = torch.empty((c, p), dtype=buf.dtype, device=buf.device)
        blocks = [buf[:, o:o + n].view((c,) + tuple(s))
                  for o, n, s in self._spans(self.local_decls)]
        dsts = [out[:, o:o + n].view((c,) + tuple(s)) for o, n, s in full]
        self._gather_into(blocks, dsts, c)
        return out

    def gather_flat(self, local) -> torch.Tensor:
        """A tree of this rank's blocks -> the whole tree as one (P,) float32
        vector (the fused layout of the base and the momentum)."""
        leaves = tree.leaves(local)
        full = self._spans(self.decls)
        out = torch.empty((sum(n for _, n, _ in full),), dtype=torch.float32,
                          device=leaves[0].device)
        for i, (x, (o, n, s)) in enumerate(zip(leaves, full)):
            view = out[o:o + n].view(tuple(s))
            if x.dtype == torch.float32:
                self._gather_into([x], [view], None, [i])
            else:  # staged one leaf at a time in its own dtype
                staged = torch.empty(tuple(s), dtype=x.dtype, device=x.device)
                self._gather_into([x], [staged], None, [i])
                view.copy_(staged)
                del staged
        return out

    def gather_tree(self, local):
        """A tree of this rank's blocks -> the whole tree (each leaf in its
        dtype, on its device)."""
        leaves = tree.leaves(local)
        dsts = [torch.empty(tuple(d.shape), dtype=x.dtype, device=x.device)
                for x, d in zip(leaves, tree.leaves(self.decls))]
        self._gather_into(leaves, dsts, None)
        return tree.unflatten(local, dsts)

    def shard_flat(self, vec: torch.Tensor, like, *, flat: bool = False):
        """A whole (P,) vector -> this rank's blocks as a tree shaped like
        ``like`` (its leaves' dtypes), each a copy; with ``flat`` the
        blocks are float32 views of one (P_local,) buffer in leaf order
        (the server momentum's layout)."""
        slices = self.rules.block_slices(self.decls)
        full = self._spans(self.decls)
        leaves = tree.leaves(like)
        buf = None
        if flat:
            buf = torch.empty((sum(x.numel() for x in leaves),), dtype=torch.float32,
                              device=vec.device)
        out, off = [], 0
        for x, sl, (o, n, s) in zip(leaves, slices, full):
            src = vec[o:o + n].view(tuple(s))[sl]
            if flat:
                dst = buf[off:off + x.numel()].view(x.shape)
                off += x.numel()
            else:
                dst = torch.empty(x.shape, dtype=x.dtype, device=vec.device)
            out.append(dst.copy_(src))
        return tree.unflatten(like, out)

    def shard_tree(self, full):
        """A whole tree -> this rank's blocks (copies)."""
        return self.rules.shard_tree(full, self.decls)


@dataclasses.dataclass(frozen=True)
class SequenceParallel:
    """One rank's view of the static engine's sequence split over the data
    ``axes`` (see the module docstring). Build it with :meth:`from_rules`."""

    mesh: object  # dist.meshes.Mesh
    layout: object  # dist.sharding.ServeLayout, kind "sequence"

    @classmethod
    def from_rules(cls, rules, batch: int, prompt_len: int):
        """The view for a (batch, prompt_len) static batch under ``rules``;
        None unless its layout splits the sequence."""
        layout = rules.serve_layout(batch, prompt_len)
        return cls(rules.mesh, layout) if layout.kind == "sequence" else None

    @property
    def _group(self):
        return self.mesh.group(self.layout.axes)

    def prompt_span(self, n: int) -> tuple[int, int]:
        return self.layout.prompt_span(n)

    def cache_span(self, n: int) -> tuple[int, int]:
        return self.layout.cache_span(n)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Each rank's (B, span, ...) -> the whole (B, ways · span, ...),
        spans in rank order."""
        ways = self.layout.ways
        out = torch.empty((ways,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        _all_gather(out.view(-1), x.contiguous().view(-1), self._group)
        return out.movedim(0, 1).flatten(1, 2)

    def merge(self, m: torch.Tensor, l: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """The ranks' partial decode attentions (``layers.attention_decode_partial``)
        merged: the max over the ranks, then each rank's sums and output
        rescaled to it and summed (two all-reduces)."""
        from repro_torch.models.layers import merge_attention_partials

        def reduce_max(t):
            torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                         group=self._group)
            return t

        def reduce_sum(t):
            torch.distributed.all_reduce(t, group=self._group)
            return t

        return merge_attention_partials(m, l, o, reduce_max, reduce_sum)

    def last(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the last rank of the split holds it (the prompt's last
        position), on every rank."""
        dist = torch.distributed
        y = x.contiguous().clone()
        dist.broadcast(y, dist.get_global_rank(self._group, self.layout.ways - 1),
                       group=self._group)
        return y


def _paths(decls, prefix=()):
    """Leaf paths (tuples of keys) in leaf order."""
    if isinstance(decls, dict):
        return [p for k in sorted(decls) for p in _paths(decls[k], prefix + (k,))]
    return [prefix]
