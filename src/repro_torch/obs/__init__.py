"""Observability of the port (``repro/obs``): pluggable trackers
(``trackers``), metric taps on the loops (``tap``) and the shared
history and summary schema (``history``)."""
from repro_torch.obs.history import finalize_history, summary_metrics
from repro_torch.obs.tap import MetricTap
from repro_torch.obs.trackers import (
    CompositeTracker,
    CsvTracker,
    JsonlTracker,
    MemoryTracker,
    NoopTracker,
    Tracker,
    tracker_from_spec,
)

__all__ = [
    "Tracker",
    "NoopTracker",
    "JsonlTracker",
    "CsvTracker",
    "MemoryTracker",
    "CompositeTracker",
    "tracker_from_spec",
    "MetricTap",
    "finalize_history",
    "summary_metrics",
]
