from repro_torch.obs.history import finalize_history, summary_metrics

__all__ = ["finalize_history", "summary_metrics"]
