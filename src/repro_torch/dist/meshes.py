"""Mesh plans: how a pool of ranks factorizes into FedFog's parallel axes
(port of ``repro/dist/meshes.py``).

The round (fl/round.py) distributes over four kinds of axes:

    pod      inter-pod replica axis (multi-pod only; size 2); with a fog
             tier it IS the fog tier
    client   concurrent FL cohort slots: each rank along it trains its
             share of the slots; Eq. 6's aggregation is the ONE
             collective that crosses it
    zero     intra-slot data axis: each slot's local batch splits here
    model    two tensor axes: ("expert", "tp") for MoE archs, ("tp", "sp")
             otherwise; the DENSE family's round executes tp and sp
             (``dist.tensor_parallel``), the expert axis is not ported

A :class:`MeshPlan` is pure arithmetic, the JAX package's verbatim;
:meth:`MeshPlan.build_mesh` is the only call that touches
``torch.distributed``. In place of ``jax.make_mesh`` it returns a
:class:`Mesh`: the axes and their sizes, this rank's coordinates and the
process group of every axis set the round reduces over. Ranks are laid
out row-major over the plan's axes, as JAX lays out a mesh's devices.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

# Production contract (launch/mesh.py in the JAX package): per-pod data ×
# model factorization.
DATA_PER_POD = 16
MODEL_PER_POD = 16
DEFAULT_ZERO = 2


def _largest_divisor(budget: int, dim: int) -> int:
    """Largest divisor of ``budget`` that also divides ``dim``."""
    for c in sorted((d for d in range(1, budget + 1) if budget % d == 0),
                    reverse=True):
        if dim % c == 0:
            return c
    return 1


def rank_devices(backend: str, world_size: int, device) -> list[torch.device]:
    """The device of every rank: the CPU, or on CUDA one card per rank
    (``nccl``, which refuses two ranks on one card) or the cards in turn
    (``gloo``, whose collectives stage CUDA tensors through host memory).
    Asking for ``nccl`` with fewer cards than ranks raises: nothing
    switches backend silently."""
    dev = torch.device(device)
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}: gloo or nccl")
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on CUDA devices only; use backend='gloo' on the CPU")
        return [dev] * world_size
    if dev.type != "cuda":
        raise ValueError(f"no distributed route for device {dev}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' for the CPU")
    if backend == "nccl" and world_size > cards:
        raise ValueError(
            f"nccl needs one card per rank: {world_size} ranks on {cards} card(s); "
            "use backend='gloo' to share cards")
    return [torch.device("cuda", r % cards) for r in range(world_size)]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the plan's rank grid.

    ``groups`` maps an axis set (a tuple of axis names) to this rank's
    process group along it (the ranks that share every other coordinate).
    Only sets of extent > 1 have a group: a set of extent 1 needs no
    collective."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def coords(self) -> dict[str, int]:
        """This rank's coordinate along every axis (row-major layout)."""
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.axis_sizes))):
            out[name] = r % n
            r //= n
        return {a: out[a] for a in self.axis_names}

    def ways(self, axes) -> int:
        """Extent of an axis set (axes not in the mesh count 1)."""
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axes) -> int:
        """This rank's row-major position within an axis set."""
        idx, coords = 0, self.coords
        for a in axes:
            idx = idx * self.shape.get(a, 1) + coords.get(a, 0)
        return idx

    def group(self, axes):
        """This rank's process group along ``axes`` (axes of extent 1 do not
        tell two sets apart)."""
        key = tuple(axes)
        if key in self.groups:
            return self.groups[key]
        shape = self.shape

        def wide(k):
            return tuple(a for a in k if shape.get(a, 1) > 1)

        for k, g in self.groups.items():
            if wide(k) == wide(key):
                return g
        raise KeyError(f"no process group along {key} (extent {self.ways(key)}); "
                       f"built: {sorted(self.groups)}")


def split_fog_axes(mesh, client_axes, fog_nodes: int
                   ) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """Split client mesh axes into (fog prefix, edge suffix).

    The fog tier must align with the rank layout for the two reductions
    to be a real hierarchy: ``fog_nodes`` has to equal the product of a
    LEADING prefix of the client axes (pod-major layout); axes not in the
    mesh count 1. Raises when no prefix matches. The one rule for which
    client axes form the fog tier: the sharded server pass reduces along
    it and ``dist.collectives`` checks the ledger against it."""
    axes = (client_axes,) if isinstance(client_axes, str) else tuple(client_axes)
    prod = 1
    for i in range(len(axes) + 1):
        if prod == fog_nodes:
            return axes[:i], axes[i:]
        if i < len(axes):
            prod *= int(mesh.shape.get(axes[i], 1))
    sizes = tuple(mesh.shape.get(a, 1) for a in axes)
    raise ValueError(
        f"fog_nodes={fog_nodes} must equal the product of a leading "
        f"prefix of the client mesh axes {axes} (sizes {sizes}); "
        "use a multi_pod plan whose pod axis is the fog tier"
    )


def axis_groups(names: tuple[str, ...], sizes: tuple[int, ...], axes) -> list[list[int]]:
    """Every group of global ranks along ``axes``: ranks that share all
    other coordinates, each group in row-major order along ``axes``, the
    groups in row-major order of the other coordinates."""
    shape = dict(zip(names, sizes))
    axes = [a for a in axes if a in shape]
    others = [a for a in names if a not in axes]
    strides = {}
    s = 1
    for a in reversed(names):
        strides[a] = s
        s *= shape[a]

    def ranks_of(coords: dict) -> int:
        return sum(coords[a] * strides[a] for a in names)

    def grid(ax):
        if not ax:
            yield {}
            return
        for head in range(shape[ax[0]]):
            for rest in grid(ax[1:]):
                yield {ax[0]: head, **rest}

    return [[ranks_of({**o, **a}) for a in grid(axes)] for o in grid(others)]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Axis factorization of one training / serving pool of ranks.

    ``num_clients`` is the TOTAL slot count across pods; per-pod it is
    ``num_clients // num_pods``. Invariants (the JAX package's):

        num_clients * zero == num_pods * DATA_PER_POD   (production plans)
        model_split[0] * model_split[1] == MODEL_PER_POD
        num_experts % model_split[0] == 0               (MoE archs)
        num_heads   % model_split[0] == 0               (dense archs, tp>1)
    """

    num_pods: int
    num_clients: int  # total across pods
    zero: int
    model_axes: tuple[str, str]
    model_split: tuple[int, int]
    fsdp_params: bool = True

    @property
    def multi_pod(self) -> bool:
        return self.num_pods > 1

    @property
    def client_axes(self) -> tuple[str, ...]:
        """Mesh axes the slot dim shards over."""
        return ("pod", "client") if self.multi_pod else ("client",)

    @property
    def data_axes(self) -> tuple[str, ...]:
        """Mesh axes a serving batch dim shards over (all non-model axes)."""
        return self.client_axes + ("zero",)

    @property
    def axis_names(self) -> tuple[str, ...]:
        base = ("pod",) if self.multi_pod else ()
        return base + ("client", "zero") + self.model_axes

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        base = (self.num_pods,) if self.multi_pod else ()
        return base + (
            self.num_clients // self.num_pods,
            self.zero,
        ) + self.model_split

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def device_count(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def model_ways(self) -> int:
        return math.prod(self.model_split)

    def axis_sets(self) -> list[tuple[str, ...]]:
        """The axis sets the round reduces over, in a fixed order: every
        contiguous run of the client axes (the flat combine and each fog
        tier's prefix / edge suffix), then zero. A plan with a model split
        adds each model axis, the two together (the tensor-parallel
        layers and the server pass's gathers) and the data axes (the
        loss, summed over the slots once, not once per model rank)."""
        ca = self.client_axes
        runs = [ca[i:j] for i in range(len(ca)) for j in range(i + 1, len(ca) + 1)]
        sets = runs + [("zero",)]
        if self.model_ways > 1:
            a, b = self.model_axes
            sets += [(a,), (b,), (a, b), self.data_axes]
        return sets

    def group_sets(self) -> list[tuple[str, ...]]:
        """The axis sets a mesh builds groups for: :meth:`axis_sets` and the
        data axes, the set a serving batch splits over (already among them
        under a model split)."""
        sets = self.axis_sets()
        return sets if self.data_axes in sets else sets + [self.data_axes]

    def build_mesh(self, backend: str = "gloo", device=None) -> Mesh:
        """This rank's :class:`Mesh`, with a process group for every axis
        set of :meth:`group_sets` whose extent is above 1, on ``device``
        (None: the CUDA card; the CPU only when asked for by name).

        Needs an initialized default group of ``device_count`` ranks (a
        one-rank plan also runs without one). Every rank creates every
        group, in the same order (``new_subgroups_by_enumeration`` takes
        the whole partition at once): a rank that skipped one would
        deadlock the others."""
        dist = torch.distributed
        inited = dist.is_available() and dist.is_initialized()
        if inited:
            world, rank = dist.get_world_size(), dist.get_rank()
            if world != self.device_count:
                raise ValueError(f"the plan needs {self.device_count} ranks; the world "
                                 f"has {world}")
            if dist.get_backend() != backend:
                raise ValueError(f"the world runs {dist.get_backend()}, not {backend}")
        elif self.device_count == 1:
            rank = 0
        else:
            raise RuntimeError(
                f"the plan needs {self.device_count} ranks: initialize "
                "torch.distributed first (repro_torch.dist.world.spawn)")
        device = resolve_device(device)
        rank_devices(backend, self.device_count, device)  # validates the route
        groups = {}
        for axes in self.group_sets():
            ways = math.prod(self.shape[a] for a in axes)
            if ways <= 1 or not inited:
                continue
            members = axis_groups(self.axis_names, self.axis_sizes, axes)
            groups[axes], _ = dist.new_subgroups_by_enumeration(members, backend=backend)
        return Mesh(self.axis_names, self.axis_sizes, rank, device, backend, groups)


def plan_for(
    cfg: ModelConfig,
    *,
    multi_pod: bool = False,
    device_count: int | None = None,
    zero: int | None = None,
) -> MeshPlan:
    """Compute the per-arch mesh plan (the JAX package's arithmetic).

    Default (``device_count=None``) is the production pool: 256 chips per
    pod as (client·zero=16) × (model=16), doubled along a leading ``pod``
    axis when ``multi_pod``. An explicit ``device_count`` builds a scaled
    host plan with NO model parallelism (client·zero = device_count): the
    plans the port executes.

    Model-axis factorization:
      * MoE archs: ``("expert", "tp")`` with the expert axis the largest
        16-divisor of ``num_experts`` (moonshot 64→16·1, mixtral 8→8·2).
      * Everything else: ``("tp", "sp")`` with tp the largest 16-divisor
        of the head count (rwkv6's heads are ``d_model//64``); archs whose
        head count resists 2-powers (hymba's 25) get tp=1 and lean on the
        ``sp`` axis for ffn/vocab/state dims.
    """
    num_pods = 2 if multi_pod else 1

    if device_count is None:
        data_per_pod = DATA_PER_POD
        model_total = MODEL_PER_POD
    else:
        if device_count % num_pods:
            raise ValueError(
                f"device_count {device_count} not divisible by {num_pods} pods"
            )
        data_per_pod = device_count // num_pods
        model_total = 1  # scaled host plans skip tensor parallelism

    z = zero if zero is not None else (
        DEFAULT_ZERO if data_per_pod % DEFAULT_ZERO == 0 else 1
    )
    if data_per_pod % z:
        raise ValueError(f"zero={z} does not divide data axis {data_per_pod}")
    clients_per_pod = data_per_pod // z

    if cfg.num_experts:
        e = _largest_divisor(model_total, cfg.num_experts)
        model_axes, model_split = ("expert", "tp"), (e, model_total // e)
    else:
        # rwkv6 has no attention heads; its head-sharded dims are d_model
        # in units of the fixed 64-wide rwkv head.
        heads = cfg.num_heads or max(cfg.d_model // 64, 1)
        t = _largest_divisor(model_total, heads)
        model_axes, model_split = ("tp", "sp"), (t, model_total // t)

    return MeshPlan(
        num_pods=num_pods,
        num_clients=clients_per_pod * num_pods,
        zero=z,
        model_axes=model_axes,
        model_split=model_split,
    )
