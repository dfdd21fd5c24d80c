"""Data and telemetry generators of the port (EMNIST-like task only)."""
from repro_torch.data.telemetry import TelemetryConfig, init_telemetry, make_profiles

__all__ = ["TelemetryConfig", "init_telemetry", "make_profiles"]
