"""The collective ledger: what a rank's program sent over which group (in
place of ``repro/dist/hlo_analysis.py``).

The JAX package reads the collectives of a round from the compiled HLO
text (``analyze_hlo``) and checks the paper's §III contract there. Eager
PyTorch compiles nothing, so there is no module text to parse and
``analyze_hlo`` has no counterpart here. Instead :class:`CollectiveLog`
wraps ``torch.distributed.all_reduce``, ``all_gather_into_tensor``,
``broadcast`` and ``reduce_scatter_tensor`` (and their newer spellings
``all_gather_single`` / ``reduce_scatter_single``) while it is entered and
records every call inside the rank, whoever makes it: the kind (in the
HLO names), the bytes of the tensor the call leaves behind (the HLO
result), the global ranks of the group and, when ``timed``, the wall ms
between a device synchronisation before and after the call.

The readers are the JAX package's, on that ledger:

  * :func:`count_axis_crossing`: ops whose group crosses mesh axes;
  * :func:`inter_client_all_reduces`: delta-sized all-reduces crossing
    the client axes;
  * :func:`assert_inter_client_contract`: exactly ONE such all-reduce a
    round, or with a fog tier one per tier; and on a plan with a model
    split, no collective over the tensor axes whose group spans two
    client coordinates;
  * :func:`tensor_axis_ops` / :func:`tensor_axis_summary`: the
    collectives of the tensor-parallel layers (groups confined to the
    model axes): count, bytes and wall ms, per local step;
  * :func:`census_line`: a serving decode step's census (count by kind,
    total bytes) in the JAX launcher's ``[serve] decode collectives``
    form, its ``analyze_hlo(...).collectives`` read off the ledger of one
    executed step.

Each op carries the round phase it ran in (:func:`labelled`, which the
round's phases set), so a reader can tell the layers' collectives in
local training from the server pass's gathers.

Every rank runs the same program, so one rank's ledger is the program's;
a group's ranks map to mesh coordinates row-major, as JAX's partition
ids do. Code that should be seen calls ``torch.distributed.<op>`` by
attribute at call time (as the port does), not a name imported earlier.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import Counter

import numpy as np
import torch

from repro_torch.dist.meshes import split_fog_axes

# name -> (HLO kind, position of ``group`` among the arguments after the
# first). The ``*_single`` names are the newer spellings of the two
# ``*_tensor`` ones (which call them); those present are wrapped too.
_WRAPPED = {
    "all_reduce": ("all-reduce", 1),
    "all_gather_into_tensor": ("all-gather", 1),
    "broadcast": ("collective-broadcast", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 2),
    "all_gather_single": ("all-gather", 1),
    "reduce_scatter_single": ("reduce-scatter", 2),
}


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    kind: str  # HLO name: all-reduce | all-gather | reduce-scatter | ...
    bytes: float  # bytes of the result tensor
    groups: list | None  # [[global ranks of the group]]; None = world
    ms: float | None = None  # wall ms (timed logs only)
    phase: str | None = None  # the round phase it ran in (``labelled``)


_LABEL: list = [None]  # the innermost ``labelled`` name


@contextlib.contextmanager
def labelled(name: str):
    """Record the collectives made inside under the phase ``name``."""
    prev, _LABEL[0] = _LABEL[0], name
    try:
        yield
    finally:
        _LABEL[0] = prev


@dataclasses.dataclass(frozen=True)
class CollectiveStats:
    ops: tuple[CollectiveOp, ...] = ()

    @property
    def count_by_kind(self) -> dict[str, int]:
        return dict(Counter(op.kind for op in self.ops))

    @property
    def bytes_by_kind(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for op in self.ops:
            out[op.kind] = out.get(op.kind, 0.0) + op.bytes
        return out

    @property
    def total_bytes(self) -> float:
        return float(sum(op.bytes for op in self.ops))


def _group_ranks(group) -> list[int]:
    dist = torch.distributed
    if group is None or group is dist.group.WORLD:
        return list(range(dist.get_world_size()))
    return list(dist.get_process_group_ranks(group))


class CollectiveLog:
    """Context manager recording this rank's collectives (see the module
    docstring) in ``ops``; ``stats()`` is the ledger as
    :class:`CollectiveStats`. Logs nest: an inner log sees the calls, then
    hands them on to the outer one."""

    def __init__(self, *, timed: bool = False):
        self.timed = timed
        self.ops: list[CollectiveOp] = []
        self._saved: list = []
        self._inside = False  # a wrapped call that calls another is one op

    def stats(self) -> CollectiveStats:
        return CollectiveStats(tuple(self.ops))

    def _wrap(self, name: str, fn):
        kind, pos = _WRAPPED[name]

        def wrapper(tensor, *args, **kwargs):
            if self._inside:
                return fn(tensor, *args, **kwargs)
            group = kwargs.get("group", args[pos] if len(args) > pos else None)
            sync = self.timed and tensor.is_cuda
            if sync:
                torch.cuda.synchronize(tensor.device)
            t0 = time.perf_counter()
            self._inside = True
            try:
                out = fn(tensor, *args, **kwargs)
            finally:
                self._inside = False
            if sync:
                torch.cuda.synchronize(tensor.device)
            ms = (time.perf_counter() - t0) * 1e3 if self.timed else None
            self.ops.append(CollectiveOp(kind, float(tensor.numel() * tensor.element_size()),
                                         [_group_ranks(group)], ms, _LABEL[0]))
            return out

        return wrapper

    def __enter__(self):
        dist = torch.distributed
        for name in _WRAPPED:
            if not hasattr(dist, name):
                continue
            saved = [getattr(dist, name), getattr(dist.distributed_c10d, name)]
            self._saved.append((name, saved))
            wrapped = self._wrap(name, saved[0])
            setattr(dist, name, wrapped)
            setattr(dist.distributed_c10d, name, wrapped)
        return self

    def __exit__(self, *exc):
        dist = torch.distributed
        for name, (top, c10d) in reversed(self._saved):
            setattr(dist, name, top)
            setattr(dist.distributed_c10d, name, c10d)
        self._saved = []


def count_axis_crossing(
    log,
    mesh,
    axes=("client",),
    kinds=("all-reduce",),
    min_bytes: float = 0.0,
    not_axes=(),
) -> int:
    """Number of collectives whose group CROSSES the given mesh axes: some
    group holds two ranks with different coordinates along one of
    ``axes``. Ranks index the mesh row-major.

    ``min_bytes`` filters metric-scalar traffic so the model-delta
    aggregation can be isolated (the paper's one inter-client collective).
    ``not_axes`` additionally requires the op to stay CONFINED to slices
    of those axes: this is how the fog contract tells a tier-local
    reduction from one flat all-reduce spanning both tiers.
    """
    return sum(1 for op in log.ops
               if op.kind in kinds and op.bytes >= min_bytes
               and _crossing(op, mesh, axes, not_axes))


def _crossing(op, mesh, axes, not_axes=()) -> bool:
    """Whether ``op``'s group crosses ``axes`` and stays within slices of
    ``not_axes`` (see :func:`count_axis_crossing`)."""
    names = list(mesh.axis_names)
    sizes = [int(mesh.shape[a]) for a in names]
    idxs = [names.index(a) for a in axes if a in names]
    not_idxs = [names.index(a) for a in not_axes if a in names]
    if not idxs:
        return False
    total = math.prod(sizes)

    def crosses(groups, which) -> bool:
        if groups is None:
            return any(sizes[i] > 1 for i in which)
        for g in groups:
            coords = np.array(np.unravel_index(np.asarray(g) % total, sizes))
            for i in which:
                if len(set(coords[i].tolist())) > 1:
                    return True
        return False

    return crosses(op.groups, idxs) and not (not_idxs and crosses(op.groups, not_idxs))


ALL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "collective-broadcast")


def _tensor_axes(rules) -> tuple[str, ...]:
    """The plan's model axes of extent > 1 (none for a plan without them)."""
    return tuple(a for a in getattr(rules.plan, "model_axes", ())
                 if int(rules.mesh.shape.get(a, 1)) > 1)


def tensor_axis_ops(log, rules, phase: str | None = None) -> list:
    """The ops whose group crosses the plan's tensor axes and no other
    (the tensor-parallel layers' copies, reduces and gathers, and the
    server pass's gathers), of ``phase`` when given."""
    axes = _tensor_axes(rules)
    data = tuple(a for a in rules.mesh.axis_names if a not in axes)
    return [op for op in log.ops if axes and (phase is None or op.phase == phase)
            and _crossing(op, rules.mesh, axes, data)]


def tensor_axis_summary(log, rules, steps: int, phase: str = "local_training") -> dict:
    """The tensor-axis collectives of ``phase`` per local step (``steps``:
    the rank's slots × local steps): count, bytes and wall ms (None for
    an untimed log), and the count by kind."""
    ops = tensor_axis_ops(log, rules, phase)
    ms = [op.ms for op in ops]
    return dict(
        count=len(ops) / steps,
        bytes=sum(op.bytes for op in ops) / steps,
        ms=(sum(ms) / steps) if ops and None not in ms else None,
        by_kind={k: v / steps for k, v in Counter(op.kind for op in ops).items()},
    )


def census_line(stats: CollectiveStats) -> str:
    """The JAX serving launcher's census line of one decode step."""
    return (f"[serve] decode collectives: {stats.count_by_kind} "
            f"total={stats.total_bytes:.2e} B")


def inter_client_all_reduces(log, rules, param_count: int) -> tuple[int, float]:
    """Count all-reduces that cross the plan's client axes AND carry the
    model-delta payload (at least half the delta's float32 bytes, which
    filters the metric scalars). Returns (count, delta_bytes).

    ``delta_bytes`` is the whole 4·P: the port keeps P whole on every zero
    rank (the JAX reference path shards it over zero, 4·P / zero)."""
    delta_bytes = 4.0 * param_count
    count = count_axis_crossing(
        log, rules.mesh, axes=rules.plan.client_axes, kinds=("all-reduce",),
        min_bytes=0.5 * delta_bytes,
    )
    return count, delta_bytes


def assert_inter_client_contract(
    log, rules, param_count: int, fog_nodes: int = 1
) -> tuple[int, float]:
    """The paper's §III communication contract on one round's ledger:
    exactly ONE delta-sized all-reduce crosses the client axes. No-op
    (count 0 by construction) when the client axes span one rank. Returns
    (count, delta_bytes); raises AssertionError on a violation.

    With ``fog_nodes > 1`` the contract is per tier: ONE delta-sized
    all-reduce confined to the edge axes (zero when the edge suffix spans
    one rank) plus ONE crossing the fog axes. Returns (edge + fog count,
    delta_bytes).

    On a plan with a model split it also holds that no collective over the
    tensor axes has a group spanning two client coordinates (each
    client shard's model group works on its own)."""
    axes = _tensor_axes(rules)
    if axes:
        spanning = sum(1 for op in log.ops
                       if _crossing(op, rules.mesh, axes)
                       and _crossing(op, rules.mesh, rules.plan.client_axes))
        if spanning:
            raise AssertionError(
                f"tensor-axis collective contract violated: {spanning} collective(s) "
                f"over {axes} span two client coordinates")
    count, delta_bytes = inter_client_all_reduces(log, rules, param_count)
    ways = getattr(rules, "client_ways", None)
    if ways is None:
        ways = math.prod(
            int(rules.mesh.shape.get(a, 1)) for a in rules.plan.client_axes
        )
    if fog_nodes > 1 and ways > 1:
        fog_axes, edge_axes = split_fog_axes(
            rules.mesh, rules.plan.client_axes, fog_nodes
        )
        min_bytes = 0.5 * delta_bytes
        edge_ways = math.prod(
            int(rules.mesh.shape.get(a, 1)) for a in edge_axes
        )
        edge_count = count_axis_crossing(
            log, rules.mesh, axes=edge_axes,
            kinds=("all-reduce",), min_bytes=min_bytes, not_axes=fog_axes,
        )
        fog_count = count_axis_crossing(
            log, rules.mesh, axes=fog_axes,
            kinds=("all-reduce",), min_bytes=min_bytes, not_axes=edge_axes,
        )
        want_edge = 1 if edge_ways > 1 else 0
        if edge_count != want_edge or fog_count != 1:
            raise AssertionError(
                f"fog-tier collective contract violated: found "
                f"{edge_count} edge-tier (axes {edge_axes}, expected "
                f"{want_edge}) and {fog_count} fog-tier (axes "
                f"{fog_axes}, expected 1) delta-sized "
                f"({delta_bytes:.0f}B) all-reduces"
            )
        return edge_count + fog_count, delta_bytes
    if ways > 1 and count != 1:
        raise AssertionError(
            f"inter-client all-reduce contract violated: found {count} "
            f"delta-sized ({delta_bytes:.0f}B) all-reduces crossing "
            f"{tuple(rules.plan.client_axes)}, expected exactly 1"
        )
    return count, delta_bytes
