"""Event-driven asynchronous FL engine on a virtual clock (port of
``repro/sim/events``).

    queue.py     — fixed-capacity masked event queue: parallel
                   ``(time, client, kind, payload)`` tensors with argmin
                   pop, batch pop and cancellation, kept on the device.
    staleness.py — the staleness-discounted Eq. 6 (FedAsync / FedBuff).
    churn.py     — client arrival / departure and battery-death
                   availability.
    engine.py    — ``AsyncFedFogSimulator``: the event loop, sharing the
                   sync simulator's client update, scheduler gating and
                   ``RoundCostModel``; its flushes run K3 on the staleness
                   route, K4 per fog, or K3's ``robust_kernel``.

The serving engine's arrival process (``serve.arrivals``) uses the queue
too. Import note: ``engine`` imports ``repro_torch.fl.simulator``; keep
this package out of ``repro_torch.sim.__init__``.
"""
from repro_torch.sim.events.churn import ChurnConfig, available_mask, init_online, step_churn
from repro_torch.sim.events.engine import AsyncConfig, AsyncFedFogSimulator, AsyncState
from repro_torch.sim.events.queue import (
    KIND_ARRIVE,
    KIND_COMPLETE,
    KIND_DEADLINE,
    KIND_DISPATCH,
    KIND_RETRY,
    Event,
    EventQueue,
    cancel_events,
    make_queue,
    peek_time,
    pop_batch,
    pop_event,
    pop_order_rank,
    push_event,
    push_events,
)
from repro_torch.sim.events.staleness import (
    async_aggregate,
    stale_discount,
    staleness_weights,
)

__all__ = [
    "AsyncConfig",
    "AsyncFedFogSimulator",
    "AsyncState",
    "ChurnConfig",
    "Event",
    "EventQueue",
    "KIND_ARRIVE",
    "KIND_COMPLETE",
    "KIND_DEADLINE",
    "KIND_DISPATCH",
    "KIND_RETRY",
    "async_aggregate",
    "available_mask",
    "cancel_events",
    "init_online",
    "make_queue",
    "peek_time",
    "pop_batch",
    "pop_event",
    "pop_order_rank",
    "push_event",
    "push_events",
    "stale_discount",
    "staleness_weights",
    "step_churn",
]
