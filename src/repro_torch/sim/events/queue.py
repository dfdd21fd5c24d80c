"""Fixed-capacity masked event queue (port of ``repro/sim/events/queue.py``:
``make_queue``, ``push_events``, ``peek_time``, ``pop_event``).

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
the JAX package's do. The queue lives on the device it is made on; the
serving engine keeps its arrival queue on the host, where a peek between
two device steps costs no device synchronisation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Array = torch.Tensor

KIND_DISPATCH = 0
KIND_COMPLETE = 1
KIND_RETRY = 2
KIND_DEADLINE = 3
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


def push_events(q: EventQueue, times, clients, kinds, payloads, mask) -> EventQueue:
    """Masked batch push: the i-th candidate with ``mask`` set lands in the
    i-th free slot, as the JAX package's scan of single pushes places it;
    candidates beyond the free slots are dropped and counted."""
    dev = q.time.device
    free = torch.nonzero(~q.valid).flatten()
    take = torch.nonzero(torch.as_tensor(mask, dtype=torch.bool, device=dev)).flatten()
    n = min(free.numel(), take.numel())
    slots, src = free[:n], take[:n]

    def put(arr, vals):
        out = arr.clone()
        out[slots] = torch.as_tensor(vals, device=dev).to(arr.dtype)[src]
        return out

    valid = q.valid.clone()
    valid[slots] = True
    return EventQueue(
        time=put(q.time, times),
        client=put(q.client, clients),
        kind=put(q.kind, kinds),
        payload=put(q.payload, payloads),
        valid=valid,
        dropped=q.dropped + (take.numel() - n),
    )


def peek_time(q: EventQueue) -> Array:
    """Earliest valid event time; +inf when empty."""
    inf = torch.full((), float("inf"), dtype=q.time.dtype, device=q.time.device)
    return torch.min(torch.where(q.valid, q.time, inf))


def pop_event(q: EventQueue) -> tuple[Event, EventQueue]:
    """Remove and return the earliest event (time order, then slot order).
    On an empty queue returns ``Event(valid=False)`` and the queue as it
    was."""
    inf = torch.full((), float("inf"), dtype=q.time.dtype, device=q.time.device)
    slot = torch.argmin(torch.where(q.valid, q.time, inf))  # first of ties
    has = torch.any(q.valid)
    ev = Event(time=q.time[slot], client=q.client[slot], kind=q.kind[slot],
               payload=q.payload[slot], valid=has)
    sel = (torch.arange(q.capacity, device=q.time.device) == slot) & has
    return ev, q._replace(valid=q.valid & ~sel)
