"""Federated runtime of the port: the dense synchronous simulator and
its delta-path helpers."""
