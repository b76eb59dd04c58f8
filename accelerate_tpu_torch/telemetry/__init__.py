"""Runtime telemetry of the port: the metrics registry the serving engine
keeps its counters and latency histograms in (`telemetry.registry`).

Request-scoped flight tracing, spans, Prometheus export and cross-host
snapshots are the JAX package's and wait for a later slice; tracing is off.
"""

from .registry import (
    DEFAULT_MS_BUCKETS,
    REGISTRY,
    Counter,
    Histogram,
    MetricError,
    Registry,
    StatsView,
    histogram,
)

__all__ = [
    "Counter",
    "DEFAULT_MS_BUCKETS",
    "Histogram",
    "MetricError",
    "REGISTRY",
    "Registry",
    "StatsView",
    "histogram",
]
