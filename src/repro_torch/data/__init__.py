"""Data and telemetry generators of the port: the EMNIST-like and
HAR-like tasks (``emnist_like``, ``har_like``) and the device telemetry."""
from repro_torch.data.telemetry import TelemetryConfig, init_telemetry, make_profiles

__all__ = ["TelemetryConfig", "init_telemetry", "make_profiles"]
