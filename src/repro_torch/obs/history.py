"""One history schema for every engine (port of ``finalize_history``,
``summary_metrics`` and ``assemble_async_history`` from
``repro/obs/history.py``)."""
from __future__ import annotations

from typing import Any, Mapping


def finalize_history(
    history: dict[str, Any], *, rounds: int | None = None
) -> dict[str, Any]:
    """Append the shared derived-summary fields to ``history`` in place."""
    acc = history.get("accuracy") or []
    history["final_accuracy"] = acc[-1] if len(acc) else 0.0
    history["peak_accuracy"] = max(acc) if len(acc) else 0.0
    history["total_energy_j"] = sum(history.get("energy_j", []))
    lat = history.get("round_latency_ms")
    if lat is not None:
        n = rounds if rounds else len(lat)
        history["mean_latency_ms"] = sum(lat) / max(n, 1)
    cold = history.get("cold_starts")
    if cold is not None:
        history["total_cold_starts"] = sum(cold)
    for key, total in (
        ("fault_retries", "total_fault_retries"),
        ("fault_terminal", "total_fault_terminal"),
        ("fault_corrupt", "total_fault_corrupt"),
        ("round_skipped", "total_rounds_skipped"),
        ("fault_skipped", "total_rounds_skipped"),
    ):
        v = history.get(key)
        if v is not None:
            history[total] = sum(v) if isinstance(v, (list, tuple)) else v
    return history


def summary_metrics(history: Mapping[str, Any]) -> dict[str, Any]:
    """The summary-field subset of a finalized history."""
    keys = (
        "final_accuracy", "peak_accuracy", "total_energy_j",
        "mean_latency_ms", "total_cold_starts",
        "num_dispatches", "num_flushes", "num_completions",
        "lost_inflight", "virtual_time_ms",
        "total_fault_retries", "total_fault_terminal",
        "total_fault_corrupt", "total_rounds_skipped",
        "fault_lost_deadline", "queue_dropped",
    )
    return {k: history[k] for k in keys if k in history}


def assemble_async_history(
    m_flush: Mapping[str, Any],
    m_dispatch: Mapping[str, Any],
    n_flushes: int,
    n_dispatches: int,
) -> dict[str, Any]:
    """The async engine's fixed-capacity metric arrays (host arrays),
    trimmed to the flush and dispatch counts, the dispatch channels named
    ``dispatch_*``; ``valid``, the padding marker, is dropped."""
    history: dict[str, Any] = {
        k: [float(x) for x in v[:n_flushes]] for k, v in m_flush.items() if k != "valid"
    }
    for k, v in m_dispatch.items():
        history[f"dispatch_{k}"] = [float(x) for x in v[:n_dispatches]]
    return history
