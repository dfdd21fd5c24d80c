"""Fixed-capacity masked event queue (port of ``repro/sim/events/queue.py``).

A priority queue keyed on virtual time, stored as parallel tensors of a
static capacity ``C``:

    time    (C,) float32 — event firing time (virtual ms); +inf when free
    client  (C,) int32   — client id (-1 for server-side events)
    kind    (C,) int32   — event kind (KIND_*)
    payload (C,) float32 — one scalar of event data
    valid   (C,) bool    — slot occupancy mask
    dropped () int32     — events lost to capacity overflow

A push writes the first free slot; a pop removes the earliest valid
event, ties broken on the lowest slot, so the pop order is deterministic.
Every function returns a new queue and leaves its argument unchanged, as
the JAX package's do, and none reads a value back to the host: the async
engine keeps its queue on the card and decides between two steps only.
The serving engine keeps its arrival queue on the host, where a peek
between two device steps costs no device synchronisation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Array = torch.Tensor

KIND_DISPATCH = 0  # server admits a cohort through the scheduler gate
KIND_COMPLETE = 1  # one client's update arrives at the server
KIND_RETRY = 2  # a failed invocation relaunches after backoff (faults)
KIND_DEADLINE = 3  # server round deadline fires; overdue work is shed
KIND_ARRIVE = 4  # a serving request arrives (serve.arrivals)


class EventQueue(NamedTuple):
    time: Array
    client: Array
    kind: Array
    payload: Array
    valid: Array
    dropped: Array

    @property
    def capacity(self) -> int:
        return self.time.shape[0]


class Event(NamedTuple):
    """One popped event; ``valid`` is False when the queue was empty."""

    time: Array
    client: Array
    kind: Array
    payload: Array
    valid: Array


def make_queue(capacity: int, device: str | torch.device = "cpu") -> EventQueue:
    """An empty queue with ``capacity`` slots on ``device``."""
    f = dict(device=device)
    return EventQueue(
        time=torch.full((capacity,), float("inf"), dtype=torch.float32, **f),
        client=torch.full((capacity,), -1, dtype=torch.int32, **f),
        kind=torch.full((capacity,), -1, dtype=torch.int32, **f),
        payload=torch.zeros((capacity,), dtype=torch.float32, **f),
        valid=torch.zeros((capacity,), dtype=torch.bool, **f),
        dropped=torch.zeros((), dtype=torch.int32, **f),
    )


def _as(x, like: Array) -> Array:
    """``x`` (a Python number or a tensor) as a tensor of ``like``'s dtype
    on its device; a number becomes a fill, never a host copy."""
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype)
    return torch.full((), x, dtype=like.dtype, device=like.device)


def push_event(q: EventQueue, time, client, kind, payload=0.0, enable=True) -> EventQueue:
    """Insert one event into the first free slot (no-op when ``enable``,
    a bool or a () bool tensor, is False). A full queue drops the event
    and counts it in ``dropped``."""
    if enable is False:
        return q
    dev = q.time.device
    free = ~q.valid
    has_free = torch.any(free)
    slot = torch.argmax(free.to(torch.uint8))  # first free slot; 0 if full
    do = has_free if enable is True else has_free & enable
    sel = (torch.arange(q.capacity, device=dev) == slot) & do

    def put(arr, val):
        return torch.where(sel, _as(val, arr), arr)

    lost = ~has_free if enable is True else enable & ~has_free
    return EventQueue(
        time=put(q.time, time),
        client=put(q.client, client),
        kind=put(q.kind, kind),
        payload=put(q.payload, payload),
        valid=q.valid | sel,
        dropped=q.dropped + lost.to(torch.int32),
    )


def push_events(q: EventQueue, times, clients, kinds, payloads, mask) -> EventQueue:
    """Masked batch push: the i-th candidate with ``mask`` set lands in the
    i-th free slot, as the JAX package's scan of single pushes places it;
    candidates beyond the free slots are dropped and counted. The slots
    come from prefix counts and one scatter, so nothing is read back to
    the host."""
    dev = q.time.device
    c = q.capacity
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    free = ~q.valid
    n_free = torch.sum(free.to(torch.int64))
    # Free slots in slot order, then the occupied ones.
    order = torch.argsort(q.valid.to(torch.uint8), stable=True)
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1  # candidate's rank
    ok = mask & (rank < n_free)
    target = torch.where(ok, order[torch.clamp(rank, 0, c - 1)], c)  # c: a spare

    def put(arr, vals):
        vals = torch.as_tensor(vals, device=dev).to(arr.dtype).expand(mask.shape)
        out = torch.cat([arr, arr[:1]])
        return out.scatter(0, target, vals)[:c]

    valid = torch.cat([q.valid, q.valid[:1]]).scatter(
        0, target, torch.ones_like(mask))[:c]
    return EventQueue(
        time=put(q.time, times),
        client=put(q.client, clients),
        kind=put(q.kind, kinds),
        payload=put(q.payload, payloads),
        valid=valid,
        dropped=q.dropped + torch.sum((mask & ~ok).to(torch.int32)),
    )


def peek_time(q: EventQueue) -> Array:
    """Earliest valid event time; +inf when empty."""
    inf = torch.full((), float("inf"), dtype=q.time.dtype, device=q.time.device)
    return torch.min(torch.where(q.valid, q.time, inf))


def _at(arr: Array, slot: Array) -> Array:
    """``arr[slot]`` for a () index tensor, as a gather (indexing with a
    tensor would read the index back to the host)."""
    return torch.index_select(arr, 0, slot.reshape(1))[0]


def pop_event(q: EventQueue) -> tuple[Event, EventQueue]:
    """Remove and return the earliest event (time order, then slot order).
    On an empty queue returns ``Event(valid=False)`` and the queue as it
    was."""
    inf = torch.full((), float("inf"), dtype=q.time.dtype, device=q.time.device)
    slot = torch.argmin(torch.where(q.valid, q.time, inf))  # first of ties
    has = torch.any(q.valid)
    ev = Event(time=_at(q.time, slot), client=_at(q.client, slot),
               kind=_at(q.kind, slot), payload=_at(q.payload, slot), valid=has)
    sel = (torch.arange(q.capacity, device=q.time.device) == slot) & has
    return ev, q._replace(valid=q.valid & ~sel)


def pop_order_rank(q: EventQueue) -> Array:
    """(C,) pop-order rank of every slot: the number of valid events that
    ``pop_event`` would return before it (ascending ``(time, slot)``).
    Invalid slots get rank ``C``. O(C²) pairwise, cheap at the engine's
    capacities (N + 8)."""
    c = q.capacity
    idx = torch.arange(c, device=q.time.device)
    inf = torch.full((), float("inf"), dtype=q.time.dtype, device=q.time.device)
    t = torch.where(q.valid, q.time, inf)
    before = (t[None, :] < t[:, None]) | (
        (t[None, :] == t[:, None]) & (idx[None, :] < idx[:, None]))
    rank = torch.sum(q.valid[None, :] & before, dim=1)
    return torch.where(q.valid, rank, c)


def pop_batch(q: EventQueue, take, rank: Array | None = None):
    """Remove the first ``take`` events in pop order (``take`` an int or a
    () tensor). Returns ``(popped (C,) bool, t_last (), queue)``, where
    ``t_last`` is the time of the last popped event (-inf when none):
    exactly what ``take`` successive ``pop_event`` calls free, which the
    coalesced engine's bit-for-bit contract relies on. ``rank`` may pass
    a precomputed :func:`pop_order_rank`."""
    if rank is None:
        rank = pop_order_rank(q)
    popped = q.valid & (rank < take)
    ninf = torch.full((), float("-inf"), dtype=q.time.dtype, device=q.time.device)
    t_last = torch.max(torch.where(popped, q.time, ninf))
    return popped, t_last, q._replace(valid=q.valid & ~popped)


def cancel_events(q: EventQueue, client_mask: Array, kind: int) -> EventQueue:
    """Invalidate every queued event of ``kind`` whose client is set in
    ``client_mask`` (an (N,) bool over the client registry), e.g. the
    pending COMPLETE of a client that churned out mid-flight."""
    n = client_mask.shape[0]
    owner = torch.index_select(client_mask, 0, torch.clamp(q.client, 0, n - 1).long())
    hit = q.valid & (q.kind == kind) & (q.client >= 0) & owner
    return q._replace(valid=q.valid & ~hit)
