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

In the port's executed plans (``plan_for(device_count=N)``) only the
client and zero axes act on tensors: the round keeps the parameters
replicated (FSDP of ``embed`` over zero is queued), so the specs are the
plan's arithmetic, held against the JAX package. What acts is
:meth:`ShardingRules.slot_range` (which slots a rank trains) and
:meth:`ShardingRules.batch_range` (its zero share of a slot's batch).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

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
        return tree.unflatten(decls, specs)

    def opt_spec_tree(self, decls, *, stacked: bool = False):
        """Specs for one optimizer-moment tree (ZeRO moments shard exactly
        like the weights they track)."""
        return self.param_specs(decls, stacked=stacked, fsdp=True)

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


def make_rules(
    mesh,
    cfg: ModelConfig,
    *,
    multi_pod: bool = False,
    zero: int | None = None,
    device_count: int | None = None,
    backend: str = "gloo",
    device=None,
) -> ShardingRules:
    """Build the plan, this rank's mesh and the rules for one config.

    ``mesh`` None builds the plan's mesh (``MeshPlan.build_mesh`` on the
    initialized world, with ``backend`` and ``device``, None the CUDA
    card); an existing mesh
    must carry the plan's axis names."""
    plan = plan_for(
        cfg, multi_pod=multi_pod, device_count=device_count, zero=zero
    )
    if mesh is None:
        mesh = plan.build_mesh(backend, device)
    elif tuple(getattr(mesh, "axis_names", ())) != plan.axis_names:
        raise ValueError(
            f"mesh axes {tuple(getattr(mesh, 'axis_names', ()))} are not the "
            f"plan's {plan.axis_names}"
        )
    return ShardingRules(cfg=cfg, plan=plan, mesh=mesh)
