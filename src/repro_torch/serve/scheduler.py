"""Host-side control plane: slot scheduler + physical page allocator
(port of ``repro/serve/scheduler.py``; plain Python, no tensors).

All device state is fixed-shape, so admission and eviction decisions
live here and only index into the device programs. The scheduler keeps
the conservation invariant

    arrived == completed + rejected + in_flight + waiting

Queue policies: ``fifo`` admits in arrival order; ``edf`` fills the next
free slot with the waiting request of the nearest SLO deadline.
"""
from __future__ import annotations

import dataclasses


class PageAllocator:
    """Free-list over the physical page pool. Page 0 is reserved as the
    trash page (masked writes from inactive slots land there)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages, 0, -1))  # pop() yields 1,2,...

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: list[int]) -> None:
        for p in pages:
            assert 0 < p <= self.num_pages, p
            self._free.append(p)


@dataclasses.dataclass
class SlotState:
    """Host mirror of one device slot."""

    req: int = -1
    pages: list[int] = dataclasses.field(default_factory=list)
    remaining: int = 0  # decode tokens still to produce
    deadline_ms: float = 0.0


class SlotScheduler:
    """Admission + slot assignment with conservation counters."""

    def __init__(self, slots: int, max_queue: int = 0, policy: str = "fifo"):
        if policy not in ("fifo", "edf"):
            raise ValueError(f"unknown queue policy {policy!r}")
        self.slots = [SlotState() for _ in range(slots)]
        self.max_queue = max_queue  # 0 = unbounded
        self.policy = policy
        self.waiting: list[tuple[int, float]] = []  # (req, deadline_ms)
        self.free_slots = list(range(slots - 1, -1, -1))
        self.arrived = 0
        self.admitted = 0
        self.rejected = 0
        self.completed = 0

    # -- counters ------------------------------------------------------ #
    @property
    def in_flight(self) -> int:
        return len(self.slots) - len(self.free_slots)

    def conservation(self) -> dict[str, int]:
        c = dict(
            arrived=self.arrived,
            completed=self.completed,
            rejected=self.rejected,
            in_flight=self.in_flight,
            waiting=len(self.waiting),
        )
        assert c["arrived"] == (
            c["completed"] + c["rejected"] + c["in_flight"] + c["waiting"]
        ), f"slot conservation violated: {c}"
        return c

    # -- transitions --------------------------------------------------- #
    def on_arrival(self, req: int, deadline_ms: float) -> bool:
        """Returns False when the admission queue is full (rejected)."""
        self.arrived += 1
        if self.max_queue and len(self.waiting) >= self.max_queue:
            self.rejected += 1
            return False
        self.waiting.append((req, deadline_ms))
        if self.policy == "edf":
            self.waiting.sort(key=lambda rd: (rd[1], rd[0]))
        return True

    def next_fill(self) -> tuple[int, float] | None:
        """Peek the request that should fill the next free slot."""
        if not self.waiting or not self.free_slots:
            return None
        return self.waiting[0]

    def on_insert(self, req: int, pages: list[int], remaining: int,
                  deadline_ms: float) -> int:
        """Commit the peeked request into a slot; returns the slot id."""
        head, _ = self.waiting.pop(0)
        assert head == req, (head, req)
        slot = self.free_slots.pop()
        self.slots[slot] = SlotState(req, pages, remaining, deadline_ms)
        self.admitted += 1
        return slot

    def on_complete(self, slot: int) -> SlotState:
        """Evict a finished slot; caller frees ``state.pages``."""
        state = self.slots[slot]
        assert state.req >= 0, slot
        self.slots[slot] = SlotState()
        self.free_slots.append(slot)
        self.completed += 1
        return state
