"""Telemetry: Prometheus metrics + profiling hooks."""

from .metrics import MetricsPublisher  # noqa: F401
