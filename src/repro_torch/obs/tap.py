"""Metric taps: stream decimated per-round metrics out of the loops
(port of ``repro/obs/tap.py``).

``run_scanned()`` keeps its metrics on the device and moves them to the
host once, at the end. A ``MetricTap`` restores visibility without
giving that up for the rounds it does not emit:

  * **gate** — ``tap=None`` or ``every=0`` leaves the loops exactly as
    they are: no copy, no hook;
  * **decimation, on the host** — ``emit(metrics, step)`` is called every
    round and emits only when ``step % every == 0``; a round that does
    not emit moves nothing, and one that does moves its row's scalars to
    the host in ONE stacked copy;
  * **history unchanged** — a tap reads the metrics and writes nothing
    back, so the tapped run's history equals the untapped one bitwise.

``host_log`` gives the same rows from loops whose metrics are already on
the host (``run()``, the serving engine's decode steps).
"""
from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch.core.types import static_on
from repro_torch.obs.trackers import Tracker


class MetricTap:
    """Bridge from a loop to a host-side :class:`Tracker`.

    Args:
      tracker: the sink receiving decimated rows.
      every: decimation interval k — steps with ``step % k == 0`` emit;
        ``0`` disables the tap.
      const: host-side constants merged into every row (e.g.
        ``{"policy": "fedfog"}``).
      channel: row label written as the ``event`` field (``"round"`` for
        the simulator, ``"serve"`` for the serving launcher).
    """

    def __init__(
        self,
        tracker: Tracker,
        every: int = 10,
        *,
        const: Mapping[str, Any] | None = None,
        channel: str = "round",
    ):
        if every < 0:
            raise ValueError(f"decimation interval must be >= 0, got {every}")
        self.tracker = tracker
        self.every = int(every)
        self.const = dict(const or {})
        self.channel = channel
        self.rows_emitted = 0  # host-side receive counter

    @property
    def enabled(self) -> bool:
        """On/off: False makes the tap a no-op that the engines drop."""
        return static_on(self.every)

    def _due(self, step: int) -> bool:
        return self.enabled and int(step) % self.every == 0

    def _log(self, names, vals, step: int) -> None:
        self.rows_emitted += 1
        row = {"event": self.channel, **self.const}
        row.update(zip(names, vals))
        self.tracker.log(row, step=int(step))

    def emit(self, metrics: Mapping[str, torch.Tensor], step: int) -> None:
        """Emit one decimated row of device scalars. Call every step:
        the decision is made here, on the host, from ``step``; an emitting
        step moves its scalars (as float64, exact for float32 and int32
        metrics) to the host in one stacked copy."""
        if not self._due(step):
            return
        names = tuple(sorted(metrics))
        vals = torch.stack(
            [torch.as_tensor(metrics[n]).to(torch.float64) for n in names]
        ).cpu().tolist()
        self._log(names, vals, step)

    def host_log(self, metrics: Mapping[str, Any], step: int) -> None:
        """The same row and decimation from a host-side loop whose
        metrics are already host values."""
        if not self._due(step):
            return
        names = tuple(sorted(metrics))
        self._log(names, [float(metrics[n]) for n in names], step)
