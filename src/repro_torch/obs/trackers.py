"""Pluggable streaming-metrics trackers (port of ``repro/obs/trackers.py``).

A small surface — ``log(metrics, step=)`` for streaming rows,
``log_summary`` for end-of-run scalars, a context-manager lifecycle —
that every sink implements, so engines and launchers log against the
protocol and the backend is a construction-time choice:

  * ``NoopTracker``      — discards everything;
  * ``JsonlTracker``     — one JSON object per line, flushed per row, so
                           a tail of the file is the live run;
  * ``CsvTracker``       — columns fixed by the first logged row;
  * ``MemoryTracker``    — in-process row list (tests, smoke runs);
  * ``CompositeTracker`` — fan-out to several sinks.

``tracker_from_spec`` parses the CLI surface (``--track jsonl:PATH``,
``--track csv:PATH``, ``--track noop``, comma-separated for a
composite). Values are coerced with ``float()`` / ``int()`` on the host,
so numpy scalars and 0-dim tensors log cleanly; trackers are host-side
objects that ``repro_torch.obs.tap.MetricTap`` feeds from the loops.
"""
from __future__ import annotations

import json
import numbers
import os
import time
from typing import Any, Mapping, Sequence


def _coerce(v: Any) -> Any:
    """JSON/CSV-safe scalar: numpy scalars and 0-dim tensors → python,
    the rest verbatim."""
    if isinstance(v, bool):
        return v
    if isinstance(v, numbers.Integral):
        return int(v)
    if isinstance(v, numbers.Real):
        return float(v)
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return _coerce(v.item())
    return v


class Tracker:
    """Protocol/base class: a sink for streamed metrics.

    ``log`` receives one row of scalar metrics (an optional monotone
    ``step`` names its position in the run); ``log_summary`` receives
    end-of-run scalars. Both must be cheap and never raise into the
    training loop. ``finish`` flushes/closes; the context-manager
    lifecycle guarantees it runs.
    """

    name = "tracker"

    def log(self, metrics: Mapping[str, Any], *, step: int | None = None) -> None:
        raise NotImplementedError

    def log_summary(self, metrics: Mapping[str, Any]) -> None:
        raise NotImplementedError

    def finish(self) -> None:  # idempotent
        pass

    def __enter__(self) -> "Tracker":
        return self

    def __exit__(self, *exc) -> bool:
        self.finish()
        return False


class NoopTracker(Tracker):
    """Discard everything."""

    name = "noop"

    def log(self, metrics, *, step=None):
        pass

    def log_summary(self, metrics):
        pass


class MemoryTracker(Tracker):
    """Accumulate rows in-process — tests and benchmark harnesses."""

    name = "memory"

    def __init__(self):
        self.rows: list[dict[str, Any]] = []
        self.summaries: list[dict[str, Any]] = []

    def log(self, metrics, *, step=None):
        row = {k: _coerce(v) for k, v in metrics.items()}
        if step is not None:
            row["step"] = int(step)
        self.rows.append(row)

    def log_summary(self, metrics):
        self.summaries.append({k: _coerce(v) for k, v in metrics.items()})


class JsonlTracker(Tracker):
    """Append-only JSONL sink, one flushed line per row, so that a
    ``tail -f`` of the file sees each row while the run goes on."""

    name = "jsonl"

    def __init__(self, path: str, *, append: bool = True):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a" if append else "w")

    def _write(self, row: dict[str, Any]) -> None:
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def log(self, metrics, *, step=None):
        row = {"ts": round(time.time(), 3)}
        if step is not None:
            row["step"] = int(step)
        row.update({k: _coerce(v) for k, v in metrics.items()})
        self._write(row)

    def log_summary(self, metrics):
        row = {"ts": round(time.time(), 3), "summary": True}
        row.update({k: _coerce(v) for k, v in metrics.items()})
        self._write(row)

    def finish(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class CsvTracker(Tracker):
    """CSV sink; the header is fixed by the first logged row.

    Later rows fill missing columns with '' and drop unseen keys (a
    streaming sink cannot rewrite its header). Summaries land in the
    same file with ``summary=1`` so one file round-trips a whole run.
    """

    name = "csv"

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w", newline="")
        self._writer = None
        self._columns: list[str] | None = None

    def _ensure_writer(self, row: Mapping[str, Any]) -> None:
        if self._writer is None:
            import csv

            self._columns = ["step", "summary"] + [
                k for k in row if k not in ("step", "summary")
            ]
            self._writer = csv.DictWriter(
                self._f, fieldnames=self._columns, restval="",
                extrasaction="ignore",
            )
            self._writer.writeheader()

    def _write(self, row: dict[str, Any]) -> None:
        self._ensure_writer(row)
        self._writer.writerow(row)
        self._f.flush()

    def log(self, metrics, *, step=None):
        row = {k: _coerce(v) for k, v in metrics.items()}
        row["step"] = int(step) if step is not None else ""
        row["summary"] = 0
        self._write(row)

    def log_summary(self, metrics):
        row = {k: _coerce(v) for k, v in metrics.items()}
        row["summary"] = 1
        self._write(row)

    def finish(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class CompositeTracker(Tracker):
    """Fan a single log stream out to several sinks."""

    name = "composite"

    def __init__(self, trackers: Sequence[Tracker]):
        self.trackers = list(trackers)

    def log(self, metrics, *, step=None):
        for t in self.trackers:
            t.log(metrics, step=step)

    def log_summary(self, metrics):
        for t in self.trackers:
            t.log_summary(metrics)

    def finish(self):
        for t in self.trackers:
            t.finish()


def tracker_from_spec(spec: str | None) -> Tracker:
    """Build a tracker from a CLI spec — the ``--track`` flag surface.

    ``None``/``""``/``"noop"`` → ``NoopTracker``; ``jsonl:PATH`` /
    ``csv:PATH`` → file sinks; a comma-separated list composes, e.g.
    ``--track jsonl:run.jsonl,csv:run.csv``.
    """
    if not spec or spec == "noop":
        return NoopTracker()
    parts = [p.strip() for p in spec.split(",") if p.strip()]
    if len(parts) > 1:
        return CompositeTracker([tracker_from_spec(p) for p in parts])
    (part,) = parts
    if part == "noop":
        return NoopTracker()
    if ":" not in part:
        raise ValueError(
            f"tracker spec {part!r}: expected 'noop', 'jsonl:PATH' or "
            f"'csv:PATH' (comma-separate to compose)"
        )
    kind, path = part.split(":", 1)
    if kind == "jsonl":
        return JsonlTracker(path)
    if kind == "csv":
        return CsvTracker(path)
    raise ValueError(f"unknown tracker backend {kind!r} in spec {part!r}")
