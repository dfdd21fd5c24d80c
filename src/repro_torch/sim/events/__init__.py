"""Event-driven simulation pieces (port of ``repro/sim/events``).

Ported so far: the masked event queue's construction, batch push, peek
and pop (``queue.py``), which the serving engine's arrival process uses.
``pop_batch``, ``cancel_events``, staleness, churn and the asynchronous
FL engine come with ROADMAP.md queue 1, item 9.
"""
from repro_torch.sim.events.queue import (
    KIND_ARRIVE,
    KIND_COMPLETE,
    KIND_DEADLINE,
    KIND_DISPATCH,
    KIND_RETRY,
    Event,
    EventQueue,
    make_queue,
    peek_time,
    pop_event,
    push_events,
)

__all__ = [
    "KIND_ARRIVE", "KIND_COMPLETE", "KIND_DEADLINE", "KIND_DISPATCH", "KIND_RETRY",
    "Event", "EventQueue", "make_queue", "peek_time", "pop_event", "push_events",
]
