"""Sharding rules: logical param / batch / cache axes → mesh-axis specs
(port of ``repro/dist/sharding.py``).

The models declare LOGICAL axes per parameter dim (``ParamDecl.axes``:
"embed", "heads", "mlp", "experts", …). :class:`ShardingRules` maps those
onto the :class:`~repro_torch.dist.meshes.MeshPlan` mesh axes with a rule
table plus a divisibility guard: an axis is only taken when its size
divides the dim (GQA kv heads smaller than tp, hymba's 25 heads, etc.
fall back to replication).

A spec is a tuple with one entry per dim, the counterpart of JAX's
``PartitionSpec``: ``None`` (replicated), a mesh-axis name, or a tuple of
names (the dim splits over their product).

Rule table (production plans; size-1 axes drop out automatically):

    embed       zero            (param FSDP; off when ``plan.fsdp_params``
                                 is False or ``fsdp=False`` for serving)
    heads/kv    tp
    head_dim    sp
    mlp/vocab/ssm   tp, sp      (joint: the big ffn/vocab dims absorb the
                                 full 16-way model split)
    experts     expert
    expert_mlp  tp
    layers / None   replicated

What acts on tensors: :meth:`ShardingRules.slot_range` (which slots a
rank trains) and :meth:`ShardingRules.batch_range` (its zero share of a
slot's batch) on the client and zero axes; and, on a plan with a model
split (the production plans, or a ``MeshPlan`` built with one), the
``tp`` / ``sp`` entries of :meth:`ShardingRules.tensor_specs`: each
rank holds its block of every parameter and server-momentum leaf
(:meth:`ShardingRules.shard_tree`, :func:`spec_slices`), and the DENSE
round computes on those blocks (``dist.tensor_parallel``). A dim the
axis does not divide stays whole on every rank of that axis. ``zero``
stays off the parameters (FSDP of ``embed`` over zero is queued), so
the tensor specs are ``param_specs(..., fsdp=False)``.

Serving (:meth:`ShardingRules.serve_layout`) reads the same specs: the
weights are the rank's blocks with ``fsdp=False``; the batch splits its
rows over the data axes where they divide it (``serve_batch_specs``),
else the prompt's positions, else nothing; the cache block is the rank's
rows, its span of the sequence (where JAX's ``cache_specs`` may pick
``head_dim`` for a short cache, the port keeps the sequence split: the
layout is the port's, the values the JAX's) and, under a model split,
the kv heads its query heads read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch

from repro_torch import tree
from repro_torch.dist.meshes import MeshPlan, plan_for
from repro_torch.models.config import ModelConfig

# Logical axis -> ordered mesh-axis candidates. Axes are taken greedily
# left-to-right while the running product divides the dim.
LOGICAL_RULES: dict[str, tuple[str, ...]] = {
    "layers": (),
    "embed": ("zero",),  # FSDP; dropped when fsdp is off
    "heads": ("tp",),
    "kv": ("tp",),
    "head_dim": ("sp",),
    "mlp": ("tp", "sp"),
    "vocab": ("tp", "sp"),
    "ssm": ("tp", "sp"),
    "experts": ("expert",),
    "expert_mlp": ("tp",),
}


def entry_axes(entry) -> tuple[str, ...]:
    """A spec entry's mesh axes: () for None, one name, or the tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_slices(spec, shape, sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> tuple[slice, ...]:
    """The block of a leaf of ``shape`` that the rank at ``coords`` holds
    under ``spec``: per dim, the contiguous ``1/ways`` share at the rank's
    row-major index over the entry's axes (the whole dim for None)."""
    out = []
    for entry, n in zip(spec, shape):
        idx, ways = 0, 1
        for a in entry_axes(entry):
            idx = idx * sizes[a] + coords[a]
            ways *= sizes[a]
        per = n // ways
        out.append(slice(idx * per, (idx + 1) * per))
    return tuple(out)


def local_shape(spec, shape, sizes: Mapping[str, int]) -> tuple[int, ...]:
    """A leaf's block shape under ``spec``."""
    return tuple(n // math.prod(sizes[a] for a in entry_axes(e))
                 for e, n in zip(spec, shape))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    cfg: ModelConfig
    plan: MeshPlan
    mesh: Any  # dist.meshes.Mesh (or anything exposing .shape: dict)

    # ------------------------------------------------------------------ #
    # Axis helpers
    # ------------------------------------------------------------------ #
    def _axis_size(self, name: str) -> int:
        return int(self.mesh.shape.get(name, 1))

    def _present(self, axes) -> tuple[str, ...]:
        return tuple(a for a in axes if self._axis_size(a) > 1)

    def _as_spec_entry(self, axes):
        """Mesh-axis tuple -> spec entry (size-1 axes dropped)."""
        axes = self._present(axes)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes

    def _take_axes(self, candidates, dim: int, used: set[str]):
        """Greedy divisible prefix of ``candidates`` for a dim of extent
        ``dim``; each mesh axis is used at most once per spec."""
        chosen: list[str] = []
        prod = 1
        for a in candidates:
            size = self._axis_size(a)
            if size <= 1 or a in used:
                continue
            if dim % (prod * size):
                continue
            chosen.append(a)
            prod *= size
        used.update(chosen)
        if not chosen:
            return None
        return chosen[0] if len(chosen) == 1 else tuple(chosen)

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """Intra-slot data axes: how a slot's batch splits."""
        return self._present(("zero",))

    @property
    def client_ways(self) -> int:
        """Total mesh extent the client / slot axis is sharded over."""
        prod = 1
        for a in self._present(self.plan.client_axes):
            prod *= self._axis_size(a)
        return prod

    @property
    def zero_ways(self) -> int:
        return self._axis_size("zero")

    def fused_delta_spec(self, p_total: int | None = None, *,
                         shard_p: bool = True) -> tuple:
        """Spec of the fused (C, P) client-delta buffer: the client dim
        over the plan's client axes, the P dim over zero when it divides.
        ``shard_p=False`` keeps P whole per client shard: the layout the
        sharded delta pipeline reads, and the only one the port runs."""
        z = "zero" if shard_p and self._axis_size("zero") > 1 else None
        if z is not None and p_total is not None and p_total % self._axis_size("zero"):
            z = None
        return (self._as_spec_entry(self.plan.client_axes), z)

    @property
    def serve_batch_axes(self) -> tuple[str, ...]:
        """All data axes: how a serving batch dim shards (no slot stack)."""
        return self._present(self.plan.data_axes)

    # ------------------------------------------------------------------ #
    # This rank's rows
    # ------------------------------------------------------------------ #
    def slot_range(self, slots: int) -> tuple[int, int]:
        """``[lo, hi)``: the slots this rank trains, its client-axes
        position's contiguous block (pod-major, as a client-sharded dim
        splits)."""
        ways = self.client_ways
        if slots % ways:
            raise ValueError(f"{slots} slots do not divide over {ways} client ranks")
        per = slots // ways
        i = self.mesh.index(self._present(self.plan.client_axes))
        return i * per, (i + 1) * per

    def batch_range(self, rows: int) -> tuple[int, int]:
        """``[lo, hi)``: this rank's zero share of ``rows`` batch rows."""
        z = self.zero_ways
        if rows % z:
            raise ValueError(f"{rows} batch rows do not divide over zero={z}")
        per = rows // z
        i = self.mesh.coords.get("zero", 0)
        return i * per, (i + 1) * per

    # ------------------------------------------------------------------ #
    # Parameters / optimizer state
    # ------------------------------------------------------------------ #
    def param_specs(self, decls, *, stacked: bool = False,
                    fsdp: bool | None = None):
        """Spec tree for a ``ParamDecl`` tree (``models.api.decls(cfg)``).

        ``stacked=True`` prepends the per-slot replica axis (sharded over
        ``plan.client_axes``). ``fsdp`` overrides ``plan.fsdp_params``
        (serving passes False: no ZeRO sharding of weights)."""
        return tree.unflatten(decls, self.spec_list(decls, stacked=stacked, fsdp=fsdp))

    def spec_list(self, decls, *, stacked: bool = False, fsdp: bool | None = None) -> list:
        """:meth:`param_specs` as a list in leaf order (a spec is a tuple,
        which ``tree.leaves`` would flatten)."""
        use_fsdp = self.plan.fsdp_params if fsdp is None else fsdp
        client_entry = (
            self._as_spec_entry(self.plan.client_axes) if stacked else None
        )
        specs = []
        for decl in tree.leaves(decls):
            used: set[str] = set(self.plan.client_axes) if stacked else set()
            entries = []
            for dim, name in zip(decl.shape, decl.axes):
                rule = LOGICAL_RULES.get(name, ()) if name else ()
                if not use_fsdp:
                    rule = tuple(a for a in rule if a != "zero")
                entries.append(self._take_axes(rule, dim, used))
            if stacked:
                entries = [client_entry] + entries
            specs.append(tuple(entries))
        return specs

    def opt_spec_tree(self, decls, *, stacked: bool = False):
        """Specs for one optimizer-moment tree (ZeRO moments shard exactly
        like the weights they track)."""
        return self.param_specs(decls, stacked=stacked, fsdp=True)

    # ------------------------------------------------------------------ #
    # The tensor axes: each rank's blocks of the parameters
    # ------------------------------------------------------------------ #
    @property
    def tensor_axes(self) -> tuple[str, ...]:
        """The plan's model axes of extent > 1."""
        return self._present(self.plan.model_axes)

    @property
    def tensor_ways(self) -> int:
        return math.prod(self._axis_size(a) for a in self.tensor_axes)

    def tensor_specs(self, decls) -> list:
        """The specs, in leaf order, the round holds the parameters and the
        server momentum by (JAX ``fl_state_specs``' ``param_specs`` /
        ``opt_spec_tree`` with ``zero`` off the parameters: FSDP is not
        ported)."""
        return self.spec_list(decls, fsdp=False)

    def member_coords(self, j: int) -> dict[str, int]:
        """Mesh coordinates of member ``j`` of this rank's model group (the
        ranks that share its data coordinates, row-major over the tensor
        axes, as ``dist.meshes.axis_groups`` orders them)."""
        coords = dict(self.mesh.coords)
        for a in reversed(self.tensor_axes):
            coords[a] = j % self._axis_size(a)
            j //= self._axis_size(a)
        return coords

    def block_slices(self, decls, coords: Mapping[str, int] | None = None) -> list:
        """The slices of each leaf (in leaf order) that the rank at
        ``coords`` (this rank by default) holds."""
        coords = self.mesh.coords if coords is None else coords
        return [spec_slices(spec, d.shape, self.mesh.shape, coords)
                for spec, d in zip(self.tensor_specs(decls), tree.leaves(decls))]

    def local_decls(self, decls):
        """The declarations with each leaf's block shape."""
        return tree.unflatten(decls, [
            dataclasses.replace(d, shape=local_shape(spec, d.shape, self.mesh.shape))
            for spec, d in zip(self.tensor_specs(decls), tree.leaves(decls))])

    def shard_tree(self, full, decls, coords: Mapping[str, int] | None = None):
        """The blocks of a full tree (tensors or numpy arrays shaped like
        ``decls``) that the rank at ``coords`` holds, as contiguous
        copies (a view would keep the whole leaf alive)."""
        slices = self.block_slices(decls, coords)
        out = []
        for x, sl in zip(tree.leaves(full), slices):
            b = x[sl]
            out.append(b.clone(memory_format=torch.contiguous_format)
                       if isinstance(b, torch.Tensor) else b.copy())
        return tree.unflatten(full, out)

    def assemble(self, blocks, decls):
        """The inverse of :meth:`shard_tree`: ``blocks[j]`` is member j's
        block tree (:meth:`member_coords`); a dim replicated over an axis
        is taken from the first member that holds it."""
        first = tree.leaves(blocks[0])
        out = [torch.empty(d.shape, dtype=b.dtype, device=b.device)
               for d, b in zip(tree.leaves(decls), first)]
        seen = [set() for _ in out]
        for j, blk in enumerate(blocks):
            sl = self.block_slices(decls, self.member_coords(j))
            for i, (x, s) in enumerate(zip(tree.leaves(blk), sl)):
                key = tuple((q.start, q.stop) for q in s)
                if key not in seen[i]:
                    seen[i].add(key)
                    out[i][s] = x
        return tree.unflatten(decls, out)

    # ------------------------------------------------------------------ #
    # Batches
    # ------------------------------------------------------------------ #
    def _data_prod(self) -> int:
        prod = 1
        for a in self.serve_batch_axes:
            prod *= self._axis_size(a)
        return prod

    def train_batch_specs(self, shapes: Mapping[str, tuple]) -> dict[str, tuple]:
        """Global (slot-major) train inputs, ``{name: shape}``: the batch
        dim over ALL data axes (pod × client × zero)."""
        entry = self._as_spec_entry(self.plan.data_axes)
        prod = self._data_prod()
        out = {}
        for k, dims in shapes.items():
            dims = tuple(dims)
            if entry is not None and dims and dims[0] % prod == 0:
                out[k] = (entry,) + (None,) * (len(dims) - 1)
            else:
                out[k] = ()
        return out

    def serve_batch_specs(self, shapes: Mapping[str, tuple]) -> dict[str, tuple]:
        """Serving inputs: batch dim over all data axes; batch-unshardable
        cells (long-context, global_batch=1) fall back to sharding the
        sequence dim."""
        entry = self._as_spec_entry(self.plan.data_axes)
        prod = self._data_prod()
        out = {}
        for k, dims in shapes.items():
            dims = tuple(dims)
            if entry is None or not dims:
                out[k] = ()
            elif dims[0] % prod == 0:
                out[k] = (entry,) + (None,) * (len(dims) - 1)
            elif len(dims) >= 2 and dims[1] % prod == 0 and dims[1] >= prod:
                out[k] = (None, entry) + (None,) * (len(dims) - 2)
            else:
                out[k] = ()
        return out

    def serve_layout(self, batch: int, prompt_len: int) -> "ServeLayout":
        """This rank's :class:`ServeLayout` of a static (batch, prompt_len)
        serving batch, as ``serve_batch_specs`` splits its tokens."""
        axes = self.serve_batch_axes
        ways = self._data_prod()
        spec = self.serve_batch_specs({"tokens": (batch, prompt_len)})["tokens"]
        index = self.mesh.index(axes) if ways > 1 else 0
        if spec and spec[0] is not None:
            return ServeLayout("batch", axes, ways, index, even_span(batch, ways, index))
        kind = "sequence" if len(spec) > 1 and spec[1] is not None else "replicated"
        return ServeLayout(kind, axes, ways, index, (0, batch))

    # ------------------------------------------------------------------ #
    # Decode caches
    # ------------------------------------------------------------------ #
    def cache_specs(self, cache):
        """Specs for a decode-cache tree whose leaves have ``.shape``.

        Cache leaves are (layers, batch, ...) stacks: prefer sharding the
        batch dim (dim 1) over the data axes; when the batch is too small
        shard the largest remaining dim. The layer stack is never sharded.
        """
        entry = self._as_spec_entry(self.plan.data_axes)
        prod = self._data_prod()

        def one(leaf):
            dims = tuple(leaf.shape)
            if entry is None or len(dims) < 3:
                return ()
            none = [None] * len(dims)
            if dims[1] % prod == 0 and dims[1] >= prod:
                none[1] = entry
                return tuple(none)
            rest = sorted(range(2, len(dims)), key=lambda i: -dims[i])
            for i in rest:
                if dims[i] % prod == 0 and dims[i] >= prod:
                    none[i] = entry
                    return tuple(none)
            return ()

        return tree.map(one, cache)


def even_span(n: int, ways: int, index: int) -> tuple[int, int]:
    """``[lo, hi)``: member ``index``'s share of ``n`` positions that divide
    over ``ways``."""
    if n % ways:
        raise ValueError(f"{n} positions do not divide over {ways} ranks")
    per = n // ways
    return index * per, (index + 1) * per


def ceil_span(n: int, ways: int, index: int) -> tuple[int, int]:
    """``[lo, hi)``: member ``index``'s share of ``n`` positions in spans of
    ``ceil(n / ways)``, the last ones shorter (possibly empty)."""
    per = -(-n // ways)
    return min(index * per, n), min((index + 1) * per, n)


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """How one rank serves a static batch under mesh rules (see the module
    docstring): ``kind`` "batch" (its ``rows`` of the batch), "sequence"
    (every row; its span of the prompt and of the cache) or "replicated"
    (everything, as JAX's ``P()``), over the data ``axes`` (``ways``
    ranks, this one at ``index``)."""

    kind: str
    axes: tuple[str, ...]
    ways: int
    index: int
    rows: tuple[int, int]

    def prompt_span(self, n: int) -> tuple[int, int]:
        """The prompt positions this rank prefills."""
        if self.kind != "sequence":
            return 0, n
        return even_span(n, self.ways, self.index)

    def cache_span(self, n: int) -> tuple[int, int]:
        """The positions of an ``n``-long cache this rank holds."""
        if self.kind != "sequence":
            return 0, n
        return ceil_span(n, self.ways, self.index)


def make_rules(
    mesh,
    cfg: ModelConfig,
    *,
    multi_pod: bool = False,
    zero: int | None = None,
    device_count: int | None = None,
    backend: str = "gloo",
    device=None,
    plan: MeshPlan | None = None,
) -> ShardingRules:
    """Build the plan, this rank's mesh and the rules for one config.

    ``plan`` None is ``plan_for(cfg, ...)``; a given ``MeshPlan`` (a model
    split that only the production pool reaches, on a small world) is
    used as it is. ``mesh`` None builds the plan's mesh
    (``MeshPlan.build_mesh`` on the initialized world, with ``backend``
    and ``device``, None the CUDA card); an existing mesh must carry the
    plan's axis names."""
    if plan is None:
        plan = plan_for(cfg, multi_pod=multi_pod, device_count=device_count, zero=zero)
    if mesh is None:
        mesh = plan.build_mesh(backend, device)
    elif tuple(getattr(mesh, "axis_names", ())) != plan.axis_names:
        raise ValueError(
            f"mesh axes {tuple(getattr(mesh, 'axis_names', ()))} are not the "
            f"plan's {plan.axis_names}"
        )
    return ShardingRules(cfg=cfg, plan=plan, mesh=mesh)
